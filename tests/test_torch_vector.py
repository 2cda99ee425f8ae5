"""Port parity for the vector env (env/vector.py): TimeSteps equal to the
JAX env's step for step on one numpy action stream (illegal actions
included, auto-reset on and off), the rollout with a deterministic policy,
and twins of the JAX module's tests.  Integer fields are compared exactly;
float rewards within atol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gobblet_rl_torch.env import vector as tv
from gobblet_rl_torch.ops import batched_core as tbc
from gobblet_rl_tpu.core import rules_np
from gobblet_rl_tpu.env import vector as jv
from gobblet_rl_tpu.ops import batched_core as jbc

CPU = torch.device("cpu")


def assert_timestep_equal(tts, jts, msg=""):
    for field, t, j in zip(jv.TimeStep._fields, tts, jts):
        j = np.asarray(j)
        assert t.numpy().dtype == j.dtype, f"{field} {msg}"
        if field == "rewards":
            np.testing.assert_allclose(t.numpy(), j, atol=1e-6, rtol=0, err_msg=f"{field} {msg}")
        else:
            np.testing.assert_array_equal(t.numpy(), j, err_msg=f"{field} {msg}")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes on a few cores, where torch's thread pools would oversubscribe
    them and small ops slow down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_state_equal(tstate, jstate, msg=""):
    for field, t, j in zip(tbc.PlanesState._fields, tstate, jstate):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=f"{field} {msg}")


@pytest.mark.parametrize("auto_reset", [True, False])
def test_timesteps_match_jax_with_illegal_actions(auto_reset):
    B, S = 64, 40
    rng = np.random.default_rng(auto_reset)
    js, jts = jv.vector_reset(B)
    ts, tts = tv.vector_reset(B, CPU)
    assert_timestep_equal(tts, jts, "after reset")
    for s in range(S):
        mask = tts.mask.numpy()
        actions = np.array([rng.choice(np.nonzero(m)[0]) if m.any() else 0 for m in mask],
                           np.int32)
        illegal = rng.random(B) < 0.05                  # arbitrary actions, often illegal
        actions[illegal] = rng.integers(0, 54, int(illegal.sum()))
        js, jts = jv.vector_step(js, jnp.asarray(actions), auto_reset)
        ts, tts = tv.vector_step(ts, torch.from_numpy(actions), auto_reset)
        assert_timestep_equal(tts, jts, f"at step {s}")
        assert_state_equal(ts, js, f"at step {s}")
        if not auto_reset and s % 10 == 9:              # frozen games for a while, then reset
            js, ts = jbc.autoreset_planes(js), tbc.autoreset_planes(ts)
    assert np.asarray(jts.done).any() or np.asarray(js.done).any()


def priority_policy(generator, obs, mask, current):
    """Deterministic and state-dependent: the legal action of highest
    priority, the priorities rotated by the observation's piece count."""
    pieces = obs.reshape(obs.shape[0], -1).to(torch.int32).sum(dim=1)
    prio = (torch.arange(54) * 7 + pieces[:, None] * 5) % 54
    return torch.where(mask, prio, -1).argmax(dim=1).to(torch.int32)


def jax_priority_policy(key, obs, mask, current):
    pieces = obs.reshape(obs.shape[0], -1).astype(jnp.int32).sum(axis=1)
    prio = (jnp.arange(54) * 7 + pieces[:, None] * 5) % 54
    return jnp.argmax(jnp.where(mask, prio, -1), axis=1).astype(jnp.int32)


@pytest.mark.parametrize("collect", [False, True])
def test_rollout_deterministic_policy_matches_jax(collect):
    B, S = 48, 30
    js, jts = jv.vector_reset(B)
    js, jts, _, jout = jv.rollout(js, jax.random.PRNGKey(0), jts, jax_priority_policy, S,
                                  collect)
    ts, tts = tv.vector_reset(B, CPU)
    ts, tts, tout = tv.rollout(ts, None, tts, priority_policy, S, collect)
    assert_state_equal(ts, js)
    assert_timestep_equal(tts, jts, "final")
    if collect:
        assert_timestep_equal(tout, jout, "stacked")
    else:
        assert {k: int(v) for k, v in tout.items()} == {k: int(v) for k, v in jout.items()}
        assert int(tout["episodes"]) > 0


def test_vector_reset_shapes():
    states, ts = tv.vector_reset(16, CPU)
    assert states.board.shape == (3, 9, 16)
    assert ts.obs.shape == (16, 3, 3, 13) and ts.obs.dtype == torch.int8
    assert ts.mask.shape == (16, 54) and ts.mask.dtype == torch.bool
    assert bool(ts.mask.all())
    assert not bool(ts.done.any())
    env = tv.VectorGobbletEnv(4, device=CPU)
    state, ts = env.reset()
    state, ts = env.step(state, torch.zeros(4, dtype=torch.int32))
    assert ts.current.tolist() == [1, 1, 1, 1]


def test_vector_step_matches_host_replay():
    """8 envs on random legal action streams against an independent numpy
    replay of the rules."""
    B, S = 8, 40
    rng = np.random.default_rng(0)
    states, ts = tv.vector_reset(B, CPU)
    host_boards = [rules_np.empty_board() for _ in range(B)]
    host_player = [0] * B
    for _ in range(S):
        masks = ts.mask.numpy()
        actions = np.array([rng.choice(np.nonzero(m)[0]) for m in masks], np.int32)
        states, ts = tv.vector_step(states, torch.from_numpy(actions))
        dev_boards = states.board.permute(2, 0, 1).numpy()
        for b in range(B):
            a = int(actions[b])
            assert rules_np.legal_mask(host_boards[b], host_player[b])[a]
            host_boards[b] = rules_np.apply_action(host_boards[b], host_player[b], a)
            w = rules_np.line_winner(host_boards[b])
            if w != 0:
                assert bool(ts.done[b]) and int(ts.winner[b]) == w
                np.testing.assert_array_equal(ts.rewards[b].numpy(), [w, -w])
                np.testing.assert_array_equal(dev_boards[b], rules_np.empty_board())
                host_boards[b], host_player[b] = rules_np.empty_board(), 0
            else:
                assert not bool(ts.done[b])
                host_player[b] = 1 - host_player[b]
                np.testing.assert_array_equal(dev_boards[b], host_boards[b])


def test_fused_rollout_statistics():
    B, S = 256, 64
    states, ts = tv.vector_reset(B, CPU)
    states, ts, stats = tv.rollout(states, torch.Generator().manual_seed(0), ts,
                                   tv.random_policy, S)
    episodes = int(stats["episodes"])
    assert episodes == int(stats["wins_p1"]) + int(stats["wins_p2"])
    assert episodes > B
    assert int(stats["wins_p1"]) > 0 and int(stats["wins_p2"]) > 0
    np.testing.assert_array_equal(
        ts.mask.numpy(), tbc.legal_mask_planes(states.board, states.current).t().numpy())


def test_rollout_collect_shapes():
    B, S = 32, 16
    states, ts = tv.vector_reset(B, CPU)
    _, _, steps = tv.rollout(states, torch.Generator().manual_seed(1), ts, tv.random_policy,
                             S, collect=True)
    assert steps.obs.shape == (S, B, 3, 3, 13)
    assert steps.rewards.shape == (S, B, 2)
    assert steps.done.shape == (S, B)
