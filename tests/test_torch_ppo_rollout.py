"""Port parity for PPO's collect segment: ``make_learner_rollout`` of the
port against the JAX trainer's, on the exact float32 nets of
``torch_parity.py`` (both frameworks compute their logits bit for bit),
with JAX's per-ply draws rebuilt from its key chain and fed to the port
through ``noise=``.

The chain: each ply splits ``key, k_act, k_step = split(key, 3)``; the
learner draws ``categorical(k_act)`` (a Gumbel field of the logits' shape,
[B, 54]); the step splits ``k1, k2 = split(k_step)`` for the opponent's
reply and its opening move after a reset (a [54, B] field for random,
greedy and the search's root, [B, 54] for the "self" net's categorical).

Observations, masks, actions, rewards, done flags and the final env batch
must be identical; log-probabilities and values within 1e-6.  The search
opponent's file is test_torch_ppo_search.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gobblet_rl_torch.ops import batched_core as tbc
from gobblet_rl_torch.train import ppo as tppo
from gobblet_rl_tpu.ops import batched_core as jbc
from gobblet_rl_tpu.train import ppo as jppo
from tests.torch_parity import CPU, exact_nets, t

B, L = 8, 10
OPPONENTS = {"random": dict(opponent="random"), "greedy-1": dict(opponent="greedy", greedy_depth=1),
             "self": dict(opponent="self")}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes on a few cores, where torch's thread pools would oversubscribe
    them and small ops slow down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def configs(lp, **kw):
    base = dict(num_envs=B, segment_len=L, shared_policy=True, learner_player=lp,
                hidden_sizes=(64,), **kw)
    return jppo.PPOConfig(**base), tppo.PPOConfig(**base)


def jax_noise(key, kind, steps=L):
    """The per-ply draws of JAX's rollout started from ``key``, in the
    port's ``noise`` form."""
    opp_shape = (B, 54) if kind == "self" else (54, B)
    noise = {"act": [], "opp": [], "open": []}
    for _ in range(steps):
        key, k_act, k_step = jax.random.split(key, 3)
        k1, k2 = jax.random.split(k_step)
        noise["act"].append(jax.random.gumbel(k_act, (B, 54), jnp.float32))
        noise["opp"].append(jax.random.gumbel(k1, opp_shape, jnp.float32))
        noise["open"].append(jax.random.gumbel(k2, opp_shape, jnp.float32))
    return {k: t(np.stack(v)) for k, v in noise.items()}


def start_state(jcfg, lp, opp_params, seed):
    """A JAX env batch at the learner seats' turn (the opening move drawn
    by the random opponent), and its torch copy."""
    fn = jppo.make_opponent_fn(dataclasses.replace(jcfg, opponent="random"), None)
    jstate = jppo.init_env_state(jcfg, fn, opp_params, jax.random.PRNGKey(seed), lp)
    return jstate, tbc.PlanesState(*(t(x) for x in jstate))


def assert_rollouts_equal(jout, tout):
    (jstate, jtraj, jlast, _), (tstate, ttraj, tlast) = jout, tout
    assert jtraj.keys() == ttraj.keys()
    for k in jtraj:
        want, got = np.asarray(jtraj[k]), ttraj[k].numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, k
        if k in ("logp", "value"):
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), atol=1e-6, rtol=0)
    for name, x, y in zip(jbc.PlanesState._fields, jstate, tstate):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x), err_msg=name)


def run_both(kind, lp, jnet, params, tnet, opp, seed=0, **kw):
    """(JAX's rollout, the port's under JAX's draws) from one start state;
    ``opp`` = (params, torch net) of the frozen opponent; ``kw`` more
    config fields."""
    jcfg, tcfg = configs(lp, **OPPONENTS.get(kind, dict(opponent=kind)), **kw)
    jstate, tstate = start_state(jcfg, lp, opp[0], seed)
    key = jax.random.PRNGKey(100 + seed)
    jroll = jppo.make_learner_rollout(jcfg, jnet, jppo.make_opponent_fn(jcfg, jnet))
    jout = jax.jit(jroll, static_argnums=(4,))(params, opp[0], jstate, key, lp)
    troll = tppo.make_learner_rollout(tcfg, tppo.make_opponent_fn(tcfg, device=CPU))
    tout = troll(tnet, opp[1], tstate, None, lp, noise=jax_noise(key, kind))
    return jout, tout


@pytest.mark.parametrize("kind", list(OPPONENTS))
@pytest.mark.parametrize("lp", [0, 1, "both"])
def test_rollout_equals_jax(kind, lp):
    jnet, params, tnet = exact_nets()
    _, opp_params, opp_net = exact_nets(seed=1)
    jout, tout = run_both(kind, lp, jnet, params, tnet, (opp_params, opp_net))
    assert_rollouts_equal(jout, tout)
    done = tout[1]["done"].numpy()
    assert done.any()   # the segment crosses resets
    seats = tppo.seat_array(lp, B, CPU)
    assert torch.equal(tout[0].current, seats)   # every env at its learner seat's turn
    mask = tout[1]["mask"].numpy()
    assert mask[np.arange(L)[:, None], np.arange(B)[None], tout[1]["action"].numpy()].all()


def test_rollout_draws_from_the_generator_without_noise():
    """Without ``noise`` every draw comes from the generator: one seed
    repeats, another differs, and every recorded action is legal."""
    _, _, tnet = exact_nets()
    tcfg = tppo.PPOConfig(num_envs=B, segment_len=L, shared_policy=True, learner_player="both",
                          opponent="self", hidden_sizes=(64,))
    roll = tppo.make_learner_rollout(tcfg, tppo.make_opponent_fn(tcfg, device=CPU))
    gen = torch.Generator().manual_seed(3)
    start = tppo.init_env_state(tcfg, tppo.make_opponent_fn(tcfg, device=CPU), tnet, gen, "both")
    outs = [roll(tnet, tnet, start, torch.Generator().manual_seed(s), "both") for s in (1, 1, 2)]
    for k in outs[0][1]:
        assert torch.equal(outs[0][1][k], outs[1][1][k]), k
    assert not torch.equal(outs[0][1]["action"], outs[2][1]["action"])
    traj = outs[0][1]
    picked = traj["mask"].gather(-1, traj["action"].long()[..., None])
    assert picked.all()
