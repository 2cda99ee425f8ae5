"""The torch port's per-env rules (core/rules.py, core/rules_np.py) against
the JAX package's, bit for bit on the CPU (twins of
``tests/test_exhaustive.py`` and ``tests/test_rules.py``).

Every position two plies deep, sampled deep positions and the children of
sampled depth-2 positions go through JAX's ``batched_*`` functions and the
port's, which take the batch as a leading axis; masks, flatboards, winners,
legality and the boards after every action must be equal (tolerance 0), as
must their dtypes.  Random int8 boards that break the rules check that the
port follows JAX's level argmax and last-line-wins fold on any input.
"""

import jax
import numpy as np
import pytest
import torch

from gobblet_rl_torch.core import rules as trules
from gobblet_rl_torch.core import rules_np as trules_np
from gobblet_rl_torch.ops import batched_core as tbc
from gobblet_rl_tpu.core import rules as jrules
from gobblet_rl_tpu.core import rules_np as jrules_np

CPU = torch.device("cpu")

j_mask = jax.jit(jrules.batched_legal_mask)
j_flat = jax.jit(jrules.batched_flatboard)
j_winner = jax.jit(jrules.batched_line_winner)
j_apply = jax.jit(jrules.batched_apply_action)
j_legal = jax.jit(jax.vmap(jrules.is_legal))
j_covered = jax.jit(jax.vmap(jrules.covered))
j_invariants = jax.jit(jax.vmap(jrules.board_invariants_ok))


def _enumerate_depth2():
    seen = {}
    root = jrules_np.empty_board()
    for a1 in range(54):
        b1 = jrules_np.apply_action(root, 0, a1)
        for a2 in np.nonzero(jrules_np.legal_mask(b1, 1))[0]:
            b2 = jrules_np.apply_action(b1, 1, int(a2))
            seen[b2.tobytes()] = b2
    return list(seen.values())


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)


def _check_batch(boards, player):
    """Masks, flatboards, winners and covered sets of the port equal JAX's
    and the NumPy twins'."""
    bf = np.stack(boards)
    players = np.full(len(boards), player, np.int32)
    tb, tp = torch.from_numpy(bf), torch.from_numpy(players)
    masks = trules.batched_legal_mask(tb, tp)
    _same(masks, j_mask(bf, players))
    _same(trules.batched_flatboard(tb), j_flat(bf))
    _same(trules.batched_line_winner(tb), j_winner(bf))
    _same(trules.covered(tb), j_covered(bf))
    for i in range(0, len(boards), 97):
        np.testing.assert_array_equal(masks[i].numpy(), trules_np.legal_mask(bf[i], player))
        assert trules_np.line_winner(bf[i]) == jrules_np.line_winner(bf[i])


def test_depth2_exhaustive_parity():
    boards = _enumerate_depth2()
    assert len(boards) > 2500
    _check_batch(boards, player=0)
    _check_batch(boards, player=1)


def _deep_positions(seed=0, games=40):
    rng = np.random.default_rng(seed)
    boards = []
    for _ in range(games):
        b, player = jrules_np.empty_board(), 0
        for _ in range(int(rng.integers(10, 30))):
            mask = jrules_np.legal_mask(b, player)
            b = jrules_np.apply_action(b, player, int(rng.choice(np.nonzero(mask)[0])))
            if jrules_np.line_winner(b) != 0:
                break
            player = 1 - player
        boards.append(b)
    return boards


def test_deep_positions_sampled_parity():
    boards = _deep_positions()
    _check_batch(boards, player=0)
    _check_batch(boards, player=1)


def test_depth3_sampled_exhaustive_parity():
    rng = np.random.default_rng(7)
    depth2 = _enumerate_depth2()
    seen = {}
    for i in rng.choice(len(depth2), 120, replace=False):
        b2 = depth2[i]
        for a3 in np.nonzero(jrules_np.legal_mask(b2, 0))[0]:
            b3 = jrules_np.apply_action(b2, 0, int(a3))
            seen[b3.tobytes()] = b3
    boards = list(seen.values())
    assert len(boards) > 2000
    _check_batch(boards, player=1)


@pytest.mark.parametrize("player", [0, 1])
def test_every_action_applies_as_jax(player):
    """``is_legal`` and ``apply_action`` (with and without ``legal=``) for
    all 54 actions on deep positions, legal or not."""
    boards = np.repeat(np.stack(_deep_positions(seed=3, games=24)), 54, axis=0)
    actions = np.tile(np.arange(54, dtype=np.int32), 24)
    players = np.full(len(actions), player, np.int32)
    tb, tp, ta = (torch.from_numpy(x) for x in (boards, players, actions))
    legal = trules.is_legal(tb, tp, ta)
    _same(legal, j_legal(boards, players, actions))
    np.testing.assert_array_equal(legal.numpy().reshape(24, 54),
                                  trules.legal_mask(tb[::54], tp[::54]).numpy())
    after = trules.batched_apply_action(tb, tp, ta)
    _same(after, j_apply(boards, players, actions))
    assert torch.equal(trules.apply_action(tb, tp, ta, legal=legal), after)
    assert 0.1 < float(legal.float().mean()) < 0.9


def test_single_env_calls():
    """One env, no batch axis, python ints for player and action."""
    b = trules.empty_board(CPU)
    assert b.dtype == torch.int8 and b.shape == (3, 9)
    b = trules.apply_action(b, 0, 18)
    b = trules.apply_action(b, 1, 36)
    want = jrules_np.apply_action(jrules_np.apply_action(jrules_np.empty_board(), 0, 18), 1, 36)
    np.testing.assert_array_equal(b.numpy(), want)
    assert not bool(trules.is_legal(b, 0, 18)) and bool(trules.is_legal(b, 0, 28))
    assert trules.line_winner(b).dtype == torch.int8 and trules.line_winner(b).dim() == 0
    assert trules.player_sign(torch.tensor(1)).item() == -1


def test_arbitrary_boards_follow_jax():
    """Boards of random ids in [-6, 6] on any level (stacks out of order,
    duplicates): the level argmax and the last matching line, as JAX."""
    rng = np.random.default_rng(5)
    boards = rng.integers(-6, 7, size=(4096, 3, 9)).astype(np.int8)
    boards[rng.random(boards.shape) < 0.5] = 0
    players = rng.integers(0, 2, 4096).astype(np.int32)
    tb, tp = torch.from_numpy(boards), torch.from_numpy(players)
    _same(trules.batched_flatboard(tb), j_flat(boards))
    _same(trules.batched_line_winner(tb), j_winner(boards))
    _same(trules.batched_legal_mask(tb, tp), j_mask(boards, players))
    _same(trules.board_invariants_ok(tb), j_invariants(boards))
    # the engine's 3-way select agrees only on valid boards
    select = tbc.flat_planes(tb.permute(1, 2, 0)).t()
    assert not torch.equal(select, trules.batched_flatboard(tb))


def test_board_invariants():
    board = trules.empty_board(CPU)
    assert bool(trules.board_invariants_ok(board))
    board = trules.apply_action(board, 0, 18)
    assert bool(trules.board_invariants_ok(board))
    bad = board.clone()
    bad[1, 5] = 3              # piece 3 twice on its level
    assert not bool(trules.board_invariants_ok(bad))
    bad2 = trules.empty_board(CPU)
    bad2[0, 0] = 5             # a large piece on the small level
    assert not bool(trules.board_invariants_ok(bad2))
    for b in (board, bad, bad2):
        assert bool(trules.board_invariants_ok(b)) == bool(jrules.board_invariants_ok(b.numpy()))
    boards = np.stack(_enumerate_depth2()[:500])
    _same(trules.board_invariants_ok(torch.from_numpy(boards)), j_invariants(boards))


def test_empty_board_needs_a_device():
    if torch.cuda.is_available():
        assert trules.empty_board().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            trules.empty_board()


@pytest.mark.parametrize("name", ["empty_board", "player_sign", "covered", "flatboard",
                                  "legal_mask", "is_legal", "apply_action", "line_winner"])
def test_numpy_twin_equals_jax_twin(name):
    """The port's copy of the NumPy rules answers as the JAX package's."""
    rng = np.random.default_rng(1)
    for b in _deep_positions(seed=9, games=12):
        player = int(rng.integers(0, 2))
        action = int(rng.integers(0, 54))
        args = {"empty_board": (), "player_sign": (player,), "covered": (b,),
                "flatboard": (b,), "legal_mask": (b, player), "is_legal": (b, player, action),
                "apply_action": (b, player, action), "line_winner": (b,)}[name]
        got, want = getattr(trules_np, name)(*args), getattr(jrules_np, name)(*args)
        np.testing.assert_array_equal(got, want)
        assert np.asarray(got).dtype == np.asarray(want).dtype
