"""The torch port's own wrapper of the native engine (csrc/gobblet.cpp):
its build into ``gobblet_rl_torch/_build/``, and ``solve``, ``solve_batch``
and ``alphabeta_batch`` equal to ``gobblet_rl_tpu.native.engine``'s on
midgame positions (tolerance 0: the answers are integers).

The solver's transposition table lives in each loaded library (2 GiB once
touched), and a search's move ordering reads it, so both tables are cleared
before each comparison; the alpha-beta table is keyed on the salt, and the
comparisons use salts no other test uses.  Both tables are released at the
end of the module.
"""

import numpy as np
import pytest
import torch

from gobblet_rl_torch.native import engine as tengine
from gobblet_rl_tpu.native import engine as jengine
from tests.torch_parity import positions


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


def midgame(n, plies, seed):
    """(boards int8[n, 27], players int32[n]): live positions ``plies``
    random plies deep."""
    board, cur = positions(n, plies, seed)
    return np.ascontiguousarray(board.transpose(2, 0, 1).reshape(n, 27)), cur.astype(np.int32)


def test_builds_its_own_library_at_first_use():
    path = tengine.build()
    assert path.parent == tengine.BUILD_DIR and path.name.startswith("libgobblet-")
    assert path.parent.name == "_build" and path.parent.parent.name == "gobblet_rl_torch"
    assert tengine.build() == path                       # reused, not rebuilt
    assert tengine.load()._name == str(path)
    assert "gobblet_rl_tpu" not in str(path)


def test_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    monkeypatch.setattr(tengine, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "g++")
    monkeypatch.setattr(tengine, "CXXFLAGS", ("-fno-such-flag-at-all", "-shared"))
    with pytest.raises(RuntimeError, match="no-such-flag"):
        tengine.build()
    assert not list(tmp_path.iterdir())                  # nothing half-written is left


@pytest.mark.parametrize("depth", [12, 13, 14])
def test_solve_equals_jax(depth):
    boards, players = midgame(5, 8, depth)
    clear_both()
    got = [tengine.solve(b, int(p), depth) for b, p in zip(boards, players)]
    want = [jengine.solve(b, player=int(p), max_depth=depth) for b, p in zip(boards, players)]
    assert got == want
    assert any(r["proven"] for r in got)
    assert tengine.solve(np.zeros(27, np.int8), 0, 2)["move"] >= 0


@pytest.mark.parametrize("depth,seed", [(12, 5), (14, 6)])
def test_solve_batch_equals_jax(depth, seed):
    boards, players = midgame(12, 5 + seed % 2, seed)
    clear_both()
    got = tengine.solve_batch(boards, players, depth, seed=0x5EED0000 + seed)
    want = jengine.solve_batch(boards, players, depth, seed=0x5EED0000 + seed)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("depth", [2, 4])
def test_alphabeta_batch_equals_jax(depth):
    boards, players = midgame(16, 4, 10 + depth)
    got = tengine.alphabeta_batch(boards, players, depth, seed=0xA1FA0000 + depth)
    want = jengine.alphabeta_batch(boards, players, depth, seed=0xA1FA0000 + depth)
    np.testing.assert_array_equal(got, want)
    mask = [(jengine.load().gob_legal_mask(b, int(p)) >> int(a)) & 1
            for b, p, a in zip(boards, players, got)]
    assert all(mask)


def test_inputs_are_checked_before_the_library_reads_them():
    boards, players = midgame(4, 3, 1)
    with pytest.raises(ValueError, match="players"):
        tengine.solve_batch(boards, players[:3], 4)
    with pytest.raises(ValueError, match="27 cells"):
        tengine.solve(boards[0, :26], 0, 4)
