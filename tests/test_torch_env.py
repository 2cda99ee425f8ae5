"""The torch port's per-env transitions, observations and debug checks
(core/env.py, core/observe.py, ops/debug.py) against the JAX package's,
bit for bit on the CPU.

``step_raw`` and ``step_strict`` run batch-first in lockstep with JAX's
``batched_step_*`` on one numpy action stream that mixes legal moves with
arbitrary (often illegal) ones and keeps stepping finished games: every
field, and its dtype, must be equal at every ply (tolerance 0).
``step_strict`` must also equal the lane-major ``step_planes`` after the
``[B, 3, 9]`` <-> ``[3, 9, B]`` transpose.  The debug checks are the twins
of ``tests/test_aux_subsystems.py``'s, with ``ValueError`` in place of
``checkify``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gobblet_rl_torch.core import env as tenv
from gobblet_rl_torch.core import observe as tobserve
from gobblet_rl_torch.core import types as TT
from gobblet_rl_torch.ops import batched_core as tbc
from gobblet_rl_torch.ops import debug as tdebug
from gobblet_rl_tpu.core import env as jenv
from gobblet_rl_tpu.core import observe as jobserve
from gobblet_rl_tpu.core import rules as jrules
from gobblet_rl_tpu.core import rules_np as jrules_np
from gobblet_rl_tpu.core import types as JT
from gobblet_rl_tpu.ops import debug as jdebug

CPU = torch.device("cpu")
j_mask = jax.jit(jrules.batched_legal_mask)


def _same_state(got, want, msg=""):
    for field, t, j in zip(JT.GobbletState._fields, got, want):
        j = np.asarray(j)
        assert t.numpy().dtype == j.dtype, f"{field} {t.dtype} != {j.dtype} {msg}"
        np.testing.assert_array_equal(t.numpy(), j, err_msg=f"{field} {msg}")


def _stream(rng, masks, ply):
    """Legal actions, with arbitrary ones every third ply on a third of the
    envs (finished games get one too)."""
    actions = np.zeros(len(masks), np.int32)
    for b, mask in enumerate(masks):
        legal = np.nonzero(mask)[0]
        if (ply % 3 == 1 and b % 3 == 0) or not len(legal):
            actions[b] = rng.integers(0, 54)
        else:
            actions[b] = rng.choice(legal)
    return actions


def test_reset_matches_jax():
    _same_state(tenv.reset(CPU), jenv.reset())
    _same_state(tenv.batched_reset(5, CPU), jenv.batched_reset(jnp.arange(5)))
    z = TT.zeros_state()
    for field, t, j in zip(JT.GobbletState._fields, z, JT.zeros_state()):
        assert np.asarray(t).dtype == np.asarray(j).dtype, field
        np.testing.assert_array_equal(t, j)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tenv.reset()


@pytest.mark.parametrize("kind", ["raw", "strict"])
def test_batched_steps_lockstep_with_jax(kind):
    B, plies = 96, 40
    rng = np.random.default_rng(0 if kind == "raw" else 1)
    jstep = jax.jit(jenv.batched_step_raw if kind == "raw" else jenv.batched_step_strict)
    tstep = tenv.batched_step_raw if kind == "raw" else tenv.batched_step_strict
    js, ts = jenv.batched_reset(jnp.arange(B)), tenv.batched_reset(B, CPU)
    illegal = frozen_steps = 0
    for ply in range(plies):
        masks = np.asarray(j_mask(js.board, js.current))
        actions = _stream(rng, masks, ply)
        illegal += int((~masks[np.arange(B), actions] & ~np.asarray(js.done)).sum())
        frozen_steps += int(np.asarray(js.done).sum())
        js = jstep(js, jnp.asarray(actions))
        ts = tstep(ts, torch.from_numpy(actions))
        _same_state(ts, js, f"ply {ply}")
    assert illegal > 20 and frozen_steps > 100 and int(ts.winner.abs().sum()) > 10


@pytest.mark.parametrize("kind", ["raw", "strict"])
def test_single_env_steps_equal_jax(kind):
    """One env, no batch axis, python-int actions: a scripted win, then an
    illegal move in a fresh game, then steps of the finished games."""
    jstep = jax.jit(jenv.step_raw if kind == "raw" else jenv.step_strict)
    tstep = tenv.step_raw if kind == "raw" else tenv.step_strict
    for script in ([0, 8, 10, 16, 20, 3], [0, 0, 1, 2, 9, 9]):
        js, ts = jenv.reset(), tenv.reset(CPU)
        for a in script:
            js, ts = jstep(js, a), tstep(ts, a)
            _same_state(ts, js, f"{script} {a}")
    assert bool(ts.done) == (kind == "strict")


def test_step_strict_equals_step_planes():
    """Terminate-illegal per env, batch-first, equals the lane-major engine
    on the same stream, field for field."""
    B = 64
    rng = np.random.default_rng(2)
    ts, ps = tenv.batched_reset(B, CPU), tbc.reset_planes(B, CPU)
    for ply in range(30):
        masks = tenv.rules.batched_legal_mask(ts.board, ts.current).numpy()
        np.testing.assert_array_equal(masks, tbc.legal_mask_planes(ps.board, ps.current).t())
        actions = torch.from_numpy(_stream(rng, masks, ply))
        ts, ps = tenv.batched_step_strict(ts, actions), tbc.step_planes(ps, actions)
        assert torch.equal(ts.board, ps.board.permute(2, 0, 1))
        assert torch.equal(ts.rewards, ps.rewards.t())
        for f in ("current", "turn", "done", "winner", "last_action"):
            assert torch.equal(getattr(ts, f), getattr(ps, f)), (ply, f)


def _positions(n=40, seed=4):
    rng = np.random.default_rng(seed)
    boards, players = [], []
    for _ in range(n):
        b, player = jrules_np.empty_board(), 0
        for _ in range(int(rng.integers(0, 20))):
            mask = jrules_np.legal_mask(b, player)
            b = jrules_np.apply_action(b, player, int(rng.choice(np.nonzero(mask)[0])))
            if jrules_np.line_winner(b) != 0:
                break
            player = 1 - player
        boards.append(b)
        players.append(player)
    return np.stack(boards), np.array(players, np.int32)


def test_observe_equals_jax():
    boards, current = _positions()
    jobs = jax.jit(jax.vmap(jobserve.observe))
    for agent in (0, 1):
        agents = np.full(len(current), agent, np.int32)
        obs, mask = tobserve.observe(torch.from_numpy(boards), torch.from_numpy(agents),
                                     torch.from_numpy(current))
        want_obs, want_mask = jobs(boards, agents, current)
        for got, want in ((obs, want_obs), (mask, want_mask)):
            assert got.numpy().dtype == np.asarray(want).dtype == np.int8
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        planes = tobserve.observe_planes(torch.from_numpy(boards), torch.from_numpy(agents))
        assert torch.equal(planes, obs)
        for i in range(len(current)):
            o, m = tobserve.observe_np(boards[i], agent, int(current[i]))
            jo, jm = jobserve.observe_np(boards[i], agent, int(current[i]))
            np.testing.assert_array_equal(o, jo)
            np.testing.assert_array_equal(m, jm)
            assert o.dtype == jo.dtype and m.dtype == jm.dtype
            np.testing.assert_array_equal(o, obs[i].numpy())
    # one env, python ints
    o, m = tobserve.observe(torch.from_numpy(boards[3]), 1, int(current[3]))
    assert o.shape == (3, 3, 13) and m.shape == (54,)


def test_invariants_catch_corruption():
    state = tbc.reset_planes(8, CPU)
    assert bool(tdebug.state_invariants(state).all())
    board = state.board.clone()
    board[1, 0, 2] = 3
    board[1, 5, 2] = 3              # piece 3 twice on the medium level of env 2
    ok = tdebug.state_invariants(state._replace(board=board))
    assert not bool(ok[2]) and bool(ok[[0, 1, 3, 4, 5, 6, 7]].all())
    board2 = state.board.clone()
    board2[0, 0, 1] = 5             # a large piece on the small level of env 1
    assert not bool(tdebug.state_invariants(state._replace(board=board2))[1])
    bad_winner = state._replace(winner=torch.tensor([0, 0, 0, 2, 0, 0, 0, 0], dtype=torch.int8))
    assert tdebug.state_invariants(bad_winner).tolist() == [True] * 3 + [False] + [True] * 4
    for b in (board, board2):
        want = jdebug.planes_invariants(jnp.asarray(b.numpy()))
        np.testing.assert_array_equal(tdebug.planes_invariants(b).numpy(), np.asarray(want))


def test_checked_step_raises_on_bad_input():
    state = tbc.reset_planes(4, CPU)
    with pytest.raises(ValueError, match="action out of range"):
        tdebug.checked_step(state, torch.tensor([0, 1, 2, 60]))
    new_state = tdebug.checked_step(state, torch.tensor([0, 1, 2, 3]))
    assert int(new_state.turn[0]) == 1
    board = state.board.clone()
    board[2, 4, 0] = 6
    board[2, 7, 0] = 6
    with pytest.raises(ValueError, match="pre-step state invalid"):
        tdebug.checked_step(state._replace(board=board), torch.tensor([0, 1, 2, 3]))


def test_checked_step_post_state(monkeypatch):
    """A step that corrupts its output is caught after the step."""
    real = tbc.step_planes

    def corrupting(state, actions):
        out = real(state, actions)
        board = out.board.clone()
        board[0, :2, 1] = 1
        return out._replace(board=board)

    monkeypatch.setattr(tbc, "step_planes", corrupting)
    with pytest.raises(ValueError, match="post-step state invalid"):
        tdebug.checked_step(tbc.reset_planes(2, CPU), torch.tensor([0, 0]))
