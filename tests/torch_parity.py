"""Helpers shared by the search and AlphaZero parity tests of the torch port:
an exact float32 net in both frameworks, and random positions."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gobblet_rl_torch.models import actor_critic as tac
from gobblet_rl_torch.models.convert import actor_critic_params_from_flax, qnet_params_from_flax
from gobblet_rl_torch.models.mlp import QNet as TQNet
from gobblet_rl_torch.ops import batched_core as tbc
from gobblet_rl_tpu.models import actor_critic as jac
from gobblet_rl_tpu.models.mlp import QNet as JQNet

CPU = torch.device("cpu")


def exact_nets(hidden=(64,), seed=0):
    """(flax net, its params, the torch twin), both ``MLPActorCritic`` in
    float32, with every weight and bias a multiple of 2^-6 with a numerator
    in [-16, 16].  On 0/1 inputs and one hidden layer every dot product is
    then exact in float32, so both frameworks compute the same logits and
    values bit for bit."""
    jnet = jac.MLPActorCritic(hidden_sizes=hidden, dtype=jnp.float32)
    params = jnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, 117), jnp.int8))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda x: (rng.integers(-16, 17, x.shape) / 64).astype(np.float32),
                          params)
    tnet = tac.MLPActorCritic(hidden_sizes=hidden, dtype=torch.float32, device=CPU)
    tnet.load_state_dict(actor_critic_params_from_flax(params, "mlp"))
    return jnet, params, tnet


def exact_qnets(hidden=(64,), seed=0):
    """(flax net, its params, the torch twin): the plain-headed ``QNet`` in
    float32 with the weights of :func:`exact_nets`, so both frameworks give
    the same Q-values bit for bit.  (The dueling head's mean over 54
    actions is not exact in float32.)"""
    jnet = JQNet(hidden_sizes=hidden, dtype=jnp.float32)
    params = jnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, 117), jnp.int8))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda x: (rng.integers(-16, 17, x.shape) / 64).astype(np.float32),
                          params)
    tnet = TQNet(hidden_sizes=hidden, dtype=torch.float32, device=CPU)
    tnet.load_state_dict(qnet_params_from_flax(params))
    return jnet, params, tnet


def positions(B, plies, seed):
    """(board int8[3, 9, B], current int32[B]) as numpy arrays, ``plies``
    random plies deep (with auto-reset), drawn from a numpy Gumbel field."""
    g = np.random.default_rng(seed).gumbel(size=(plies, 54, B)).astype(np.float32)
    state, _ = tbc.rollout_random(tbc.reset_planes(B, CPU), None, plies, torch.from_numpy(g))
    return state.board.numpy(), state.current.numpy()


def japply(jnet):
    return lambda p, obs: jnet.apply(p, obs)


def t(x):
    """A torch tensor holding a copy of a numpy or JAX array."""
    return torch.from_numpy(np.array(x))
