"""The torch port's PPO policy, native-solver policies and defense audit
(eval/tournament.py) against the JAX package's.

``defense_audit`` must return the same dict as JAX's (every value is a
count or a mean of counts: tolerance 0) for the exact float32 net's
``ppo_policy`` and for the solver itself as the defender, both against an
oracle with a fixed salt.  A search's move ordering reads the solver's
transposition table, so both libraries' tables start empty and see the
same calls in the same order (a test that calls one library alone clears
both after it); proving the opening, a 13-ply win, is most of an audit's
time, and a warm table lets the second audit skip it.  Both tables are
released at the end of the module.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gobblet_rl_torch.eval import tournament as ttour
from gobblet_rl_torch.native import engine as tengine
from gobblet_rl_torch.ops import batched_core as tbc
from gobblet_rl_tpu.eval import tournament as jtour
from gobblet_rl_tpu.native import engine as jengine
from tests.torch_parity import CPU, exact_nets

DEPTH, GAMES, SALT = 14, 8, 7


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes on a few cores, where torch's thread pools would oversubscribe
    them and small ops slow down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def clear_both():
    jengine.load()
    tengine.solve_tt_clear()
    jengine.solve_tt_clear()


@pytest.fixture(scope="module", autouse=True)
def equal_tables():
    clear_both()
    yield
    clear_both()


def fixed_salt(engine, lane_major):
    """The exact solver at ``DEPTH`` with the salt ``SALT``, as a policy of
    either package."""
    def fn(_, board, current):
        boards = np.asarray(board).transpose(2, 0, 1).reshape(-1, 27)
        actions = engine.solve_batch(boards, np.asarray(current, np.int32), DEPTH, SALT)
        return lane_major(actions)
    return fn


@pytest.mark.parametrize("defender", ["ppo", "solver"])
def test_defense_audit_equals_jax(defender):
    jnet, params, tnet = exact_nets()
    joracle = fixed_salt(jengine, jnp.asarray)
    toracle = fixed_salt(tengine, torch.from_numpy)
    jpol = jtour.ppo_policy(jnet, params) if defender == "ppo" else joracle
    tpol = ttour.ppo_policy(tnet) if defender == "ppo" else toracle
    want = jtour.defense_audit(jpol, num_games=GAMES, depth=DEPTH, oracle_policy=joracle)
    got = ttour.defense_audit(tpol, num_games=GAMES, depth=DEPTH, oracle_policy=toracle,
                              device=CPU)
    assert got == want
    assert got["ungraded_games"] == 0 and got["unproven_positions"] == 0
    if defender == "solver":   # optimal defense: the proven 13-ply loss, no mistake
        assert got["mean_plies_survived"] == 13.0 and got["clean_game_frac"] == 1.0
    else:
        assert got["mistakes_per_game"] > 0


@pytest.mark.parametrize("name", ["alphabeta_batch", "solve_batch"])
def test_native_policies_are_legal_and_strong(name, monkeypatch):
    """``alphabeta_policy`` and ``solver_policy`` hand the library the
    positions as level-major rows, the movers and a salt from the policy's
    generator; their moves are legal and beat the random policy."""
    make = {"alphabeta_batch": lambda: ttour.alphabeta_policy(3),
            "solve_batch": lambda: ttour.solver_policy(8)}[name]
    gen = torch.Generator().manual_seed(0)
    state, _ = tbc.rollout_random(tbc.reset_planes(16, CPU), gen, 4)
    calls = []
    real = getattr(tengine, name)

    def recording(boards, players, depth, seed):
        calls.append((boards.copy(), players.copy(), depth, seed))
        return real(boards, players, depth, seed)

    monkeypatch.setattr(tengine, name, recording)
    a = make()(torch.Generator().manual_seed(4), state.board, state.current)
    (boards, players, depth, seed), = calls
    assert seed == int(torch.randint(0, np.iinfo(np.int32).max, (),
                                     generator=torch.Generator().manual_seed(4)))
    assert depth == (3 if name == "alphabeta_batch" else 8)
    np.testing.assert_array_equal(boards.reshape(16, 3, 9), state.board.permute(2, 0, 1).numpy())
    np.testing.assert_array_equal(players, state.current.numpy())
    assert a.dtype == torch.int32
    assert tbc.legal_mask_planes(state.board, state.current)[a.long(), torch.arange(16)].all()
    monkeypatch.undo()
    m = ttour.play_match(make(), ttour.random_policy(), num_games=16, seed=1, device=CPU)
    clear_both()
    assert m["win_rate"] > 0.8, m


def test_ppo_policy_argmax_and_sample():
    _, _, tnet = exact_nets()
    gen = torch.Generator().manual_seed(2)
    state, _ = tbc.rollout_random(tbc.reset_planes(64, CPU), gen, 3)
    mask = tbc.legal_mask_planes(state.board, state.current)
    with torch.no_grad():
        logits, _ = tnet(tbc.features_lm(state.board, state.current).t())
    greedy = ttour.ppo_policy(tnet)(None, state.board, state.current)
    assert torch.equal(greedy.long(), torch.where(mask.t(), logits, -torch.inf).argmax(-1))
    sampled = ttour.ppo_policy(tnet, sample=True)
    a = sampled(torch.Generator().manual_seed(1), state.board, state.current)
    assert torch.equal(a, sampled(torch.Generator().manual_seed(1), state.board, state.current))
    assert mask[a.long(), torch.arange(64)].all() and not torch.equal(a, greedy)
