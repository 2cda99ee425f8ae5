"""The torch port's defense bank (train/defense.py) against the JAX
package's ``generate_defense_bank``, and the twins of tests/test_defense.py.

With JAX's per-ply draws fed in through ``draws`` (the solver's salt and
the random and greedy defenders' Gumbel fields, rebuilt from JAX's key
chain), the port's bank must equal JAX's row for row (tolerance 0: every
column is an integer).  The solver's transposition table steers the
search's move ordering, so both libraries' tables are cleared before each
build; they are released at the end of the module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gobblet_rl_torch.native import engine as tengine
from gobblet_rl_torch.train import defense as tdefense
from gobblet_rl_tpu.native import engine as jengine
from gobblet_rl_tpu.train import defense as jdefense
from tests.torch_parity import CPU, t

KEYS = ("obs", "mask", "action", "board")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes on a few cores, where torch's thread pools would oversubscribe
    them and small ops slow down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def release_tables():
    yield
    tengine.solve_tt_clear()
    jengine.solve_tt_clear()


def clear_both():
    jengine.load()
    tengine.solve_tt_clear()
    jengine.solve_tt_clear()


def jax_draws(seed, num_games):
    """``draws(ply)`` rebuilding generate_defense_bank's key chain: each ply
    splits ``key, sub`` for the salt; the defender's plies (odd: every game
    starts at the opening and moves once a ply) then split ``key, k1, k2,
    k3`` for the random, greedy-1 and greedy-2 fields."""
    chain = {"key": jax.random.PRNGKey(seed)}

    def draws(ply):
        key, sub = jax.random.split(chain["key"])
        salt = int(jax.random.randint(sub, (), 0, np.iinfo(np.int32).max))
        fields = (None, None, None)
        if ply % 2 == 1:
            key, *ks = jax.random.split(key, 4)
            fields = tuple(t(jax.random.gumbel(k, (54, num_games), jnp.float32)) for k in ks)
        chain["key"] = key
        return (salt, *fields)

    return draws


def build_both(sides, games, depth, seed):
    """(JAX's bank, the port's under JAX's draws), each library's solver
    table cleared before its build."""
    clear_both()
    want = jdefense.generate_defense_bank(num_games=games, seed=seed, depth=depth, sides=sides)
    clear_both()
    got = tdefense.generate_defense_bank(num_games=games, seed=seed, depth=depth, sides=sides,
                                         device=CPU, draws=jax_draws(seed, games))
    return want, got


def assert_banks_equal(want, got, games):
    assert got.keys() == want.keys()
    for k in KEYS:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len(got["action"]) > games


@pytest.fixture(scope="module")
def banks():
    return build_both("defense", 12, 12, 3)


@pytest.fixture(scope="module")
def bank(banks):
    return banks[1]


def test_bank_equals_jax_under_jax_draws(banks):
    """sides="defense"; test_torch_defense_sides.py holds sides="both"."""
    assert_banks_equal(*banks, games=12)


def test_bank_shapes_and_legality(bank):
    n = bank["obs"].shape[0]
    assert n > 0
    assert bank["obs"].shape == (n, 117) and bank["obs"].dtype == np.int8
    assert bank["mask"].shape == (n, 54) and bank["mask"].dtype == bool
    assert bank["board"].shape == (n, 27) and bank["action"].dtype == np.int32
    assert bank["mask"][np.arange(n), bank["action"]].all()
    assert len({b.tobytes() for b in bank["board"]}) == n   # deduplicated


def test_bank_labels_are_mate_maximizing(bank):
    """From a position lost in d plies, the label reaches one lost in
    exactly d - 1 (the defense audit's grading rule), by the port's
    solver."""
    from gobblet_rl_torch.ops import batched_core as tbc

    checked = 0
    for board, action in list(zip(bank["board"], bank["action"]))[:8]:
        res = tengine.solve(board, 1, 18)
        if not res["proven"] or res["mate_in"] is None:
            continue
        d_before = res["mate_in"]
        state = tbc.reset_planes(1, CPU)._replace(
            board=torch.from_numpy(board.reshape(3, 9, 1).copy()),
            current=torch.ones(1, dtype=torch.int32))
        after = tbc.step_planes(state, torch.tensor([int(action)], dtype=torch.int32))
        if int(after.winner[0]) != 0:
            assert d_before <= 1   # lost on the spot: optimal only when already mated
            continue
        res2 = tengine.solve(after.board[..., 0].reshape(27).numpy(), 0, 18)
        assert res2["proven"] and res2["mate_in"] == d_before - 1, (d_before, res2)
        checked += 1
    assert checked > 0


def test_bank_is_deterministic():
    a = tdefense.generate_defense_bank(num_games=8, seed=5, depth=12, device=CPU)
    b = tdefense.generate_defense_bank(num_games=8, seed=5, depth=12, device=CPU)
    for k in KEYS:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_bank_checks_sides_and_device():
    with pytest.raises(ValueError, match="sides"):
        tdefense.generate_defense_bank(num_games=2, sides="attack", device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tdefense.generate_defense_bank(num_games=2)
