"""Port parity for the PPO trainer: GAE, the loss and its gradients, and
one whole iteration against optax — gobblet_rl_torch against
gobblet_rl_tpu on the CPU.  The collect segments are in
test_torch_ppo_rollout.py and test_torch_ppo_search.py; the config, the
league, the two-policy mode and resume in test_torch_ppo_train.py.

Tolerances: GAE within 1e-6; the loss, its gradients and the parameters
after an iteration within 1e-5 in float32 (the frameworks sum in
different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gobblet_rl_torch.models import actor_critic as tac
from gobblet_rl_torch.models.convert import actor_critic_params_from_flax
from gobblet_rl_torch.train import defense as tdefense
from gobblet_rl_torch.train import ppo as tppo
from gobblet_rl_tpu.models import actor_critic as jac
from gobblet_rl_tpu.train import ppo as jppo
from tests.test_torch_defense_sides import closure, ppo_batch, synthetic_bank
from tests.test_torch_ppo_rollout import jax_noise, start_state
from tests.torch_parity import CPU, exact_nets, t


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes on a few cores, where torch's thread pools would oversubscribe
    them and small ops slow down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# GAE
# ---------------------------------------------------------------------------
def test_gae_terminal_only_matches_jax():
    """tests/test_ppo.py:33: env 0 wins at t=1, env 1 never ends."""
    traj = {"value": np.asarray([[0.5, 0.1], [0.2, 0.2], [0.3, 0.3], [0.1, 0.4]], np.float32),
            "reward": np.asarray([[0, 0], [1, 0], [0, 0], [0, 0]], np.float32),
            "done": np.asarray([[0, 0], [1, 0], [0, 0], [0, 0]], bool)}
    last = np.asarray([0.0, 0.5], np.float32)
    want = jppo.compute_gae({k: jnp.asarray(v) for k, v in traj.items()}, jnp.asarray(last),
                            0.99, 0.95)
    got = tppo.compute_gae({k: t(v) for k, v in traj.items()}, t(last), 0.99, 0.95)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(got[0][1, 0]), 0.8, atol=1e-6)   # 1 - 0.2, no bootstrap


def test_gae_random_trajectory_matches_jax():
    rng = np.random.default_rng(0)
    L, B = 24, 7
    traj = {"value": rng.uniform(-1, 1, (L, B)).astype(np.float32),
            "reward": rng.choice([-1.0, 0.0, 0.0, 1.0], (L, B)).astype(np.float32),
            "done": rng.random((L, B)) < 0.2}
    last = rng.uniform(-1, 1, B).astype(np.float32)
    want = jppo.compute_gae({k: jnp.asarray(v) for k, v in traj.items()}, jnp.asarray(last),
                            0.97, 0.9)
    got = tppo.compute_gae({k: t(v) for k, v in traj.items()}, t(last), 0.97, 0.9)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (L, B)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# the loss and one iteration
# ---------------------------------------------------------------------------
def f32_nets(hidden=(32,), seed=2):
    jnet = jac.MLPActorCritic(hidden_sizes=hidden, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jnet.init(jax.random.PRNGKey(seed),
                                                jnp.zeros((1, 117), jnp.int8)))
    tnet = tac.MLPActorCritic(hidden_sizes=hidden, dtype=torch.float32, device=CPU)
    tnet.load_state_dict(actor_critic_params_from_flax(params, "mlp"))
    return jnet, params, tnet


@pytest.mark.parametrize("with_bank", [False, True])
def test_minibatch_loss_and_gradients_match_jax(with_bank):
    """One minibatch: the total loss, its three parts and every gradient
    against ``jax.value_and_grad`` of the JAX trainer's own ``loss_fn``.
    The advantages are normalised with the population std (``jnp.std``);
    torch's default, the sample std, misses by ~4e-3 here."""
    kw = dict(hidden_sizes=(32,), defense_bc_weight=0.7 if with_bank else 0.0)
    jnet, params, tnet = f32_nets()
    bank, batch = synthetic_bank(40, 3), ppo_batch(64, 4)
    jbank = {k: jnp.asarray(v) for k, v in bank.items()} if with_bank else None
    jloss_fn = closure(jppo.make_train_iteration(jppo.PPOConfig(**kw), jnet, optax.adam(1e-3),
                                                 "random", jbank), "loss_fn")
    (jtotal, jparts), jgrads = jax.value_and_grad(jloss_fn, has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    tbank = tdefense.bank_tensors(bank, CPU) if with_bank else None
    ttotal, tparts = tppo.make_loss_fn(tppo.PPOConfig(**kw), tbank)(
        tnet, {k: t(v) for k, v in batch.items()})
    ttotal.backward()
    np.testing.assert_allclose([float(x.detach()) for x in (ttotal, *tparts)],
                               [float(jtotal), *map(float, jparts)], atol=1e-5, rtol=0)
    want = actor_critic_params_from_flax(jax.tree.map(np.asarray, jgrads), "mlp")
    for name, p in tnet.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=1e-5, rtol=0,
                                   err_msg=name)


def jax_perms(key, L, epochs, n):
    """The epoch permutations of JAX's iteration: its key after the
    rollout's ``L`` three-way splits, then ``key, k_perm`` an epoch."""
    for _ in range(L):
        key, _, _ = jax.random.split(key, 3)
    perms = []
    for _ in range(epochs):
        key, k_perm = jax.random.split(key)
        perms.append(t(jax.random.permutation(k_perm, n)).long())
    return perms


@pytest.mark.parametrize("kind,lp", [("self", "both"), ("random", 1)])
def test_iteration_matches_optax(kind, lp):
    """One whole iteration (segment, GAE, 2 epochs x 4 minibatches of
    clip_by_global_norm + Adam) with JAX's draws and permutations fed in:
    the parameters, the loss and the episode stats."""
    B, L = 8, 8
    kw = dict(num_envs=B, segment_len=L, shared_policy=True, learner_player=lp, opponent=kind,
              hidden_sizes=(64,), epochs_per_iter=2, minibatches=4, lr=1e-3, max_grad_norm=0.5)
    jcfg, tcfg = jppo.PPOConfig(**kw), tppo.PPOConfig(**kw)
    jnet, params, tnet = exact_nets()
    _, opp_params, opp_net = exact_nets(seed=1)
    jstate, tstate = start_state(jcfg, lp, opp_params, 4)
    optimizer = optax.chain(optax.clip_by_global_norm(jcfg.max_grad_norm), optax.adam(jcfg.lr))
    it = jppo.make_train_iteration(jcfg, jnet, optimizer, kind)
    key = jax.random.PRNGKey(7)
    jp, _, jenv, _, jstats = it(params, opp_params, optimizer.init(params), jstate, key, lp)

    _, k_roll = jax.random.split(key)
    titer = tppo.make_train_iteration(tcfg, kind, device=CPU)
    tenv, tstats = titer(tnet, opp_net, tppo.make_optimizer(tcfg, tnet), tstate, None, lp,
                         noise=jax_noise(k_roll, kind, L),
                         perms=jax_perms(k_roll, L, jcfg.epochs_per_iter, B * L))
    for x, y in zip(jenv, tenv):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x))
    assert int(tstats["episodes"]) == int(jstats["episodes"]) > 0
    np.testing.assert_allclose([float(tstats["loss"]), float(tstats["mean_reward"])],
                               [float(jstats["loss"]), float(jstats["mean_reward"])],
                               atol=1e-5, rtol=0)
    want = actor_critic_params_from_flax(jax.tree.map(np.asarray, jp), "mlp")
    before = actor_critic_params_from_flax(params, "mlp")
    for name, p in tnet.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-5, rtol=0,
                                   err_msg=name)
        assert not torch.equal(p, before[name]), name
