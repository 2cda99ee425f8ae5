"""The one-move win check (``gobblet_rl_torch.kernels.wins``): its plain
version against a per-lane move and fold written from the host rules, on
random-game and terminal positions and on hand-built boards where a lift
reveals a line; a numpy model of the CUDA kernel's bitboard algebra against
the plain version; the tracing counters; and, on a card, the kernel against
the plain version bit for bit.  Imports no JAX, so the card test runs where
JAX is not installed."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gobblet_rl_torch.core import rules_np
from gobblet_rl_torch.kernels import wins
from gobblet_rl_torch.ops import batched_core as bc
from gobblet_rl_torch.utils import profiling
from tests.torch_bitboard import (LINES, STRIDE, U32, action_mask, full_lines, legal_set,
                                  mask_rows, words)

SEED = 2**33 + 29
CSRC = Path(wins.__file__).resolve().parent / "csrc"


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def game_positions(batch: int, plies: int, gen: torch.Generator):
    """(board, player) after ``plies`` random plies with auto-reset, so the
    lanes sit at every depth of a game up to ``plies``."""
    state, _ = bc.rollout_random(bc.reset_planes(batch, gen.device), gen, plies)
    return state.board.contiguous(), state.current.contiguous()


def terminal_positions(batch: int, gen: torch.Generator):
    """Boards that a winning move has just ended, with either player to
    move: the search checks the child of every expansion, won or not."""
    board, player = game_positions(batch, 40, gen)
    won = wins.winning_actions_plain(board, player)
    lanes = won.any(0)
    action = won.to(torch.uint8).argmax(0).to(torch.int32)
    ended = bc.apply_action_unchecked(board, player, action)[..., lanes]
    assert bool((bc.winner_planes(bc.flat_planes(ended)) != 0).all())
    return (torch.cat([ended, ended], -1).contiguous(),
            torch.cat([1 - player[lanes], player[lanes]]).to(torch.int32).contiguous())


def rules_wins(board: np.ndarray, player: np.ndarray) -> np.ndarray:
    """bool[54, B] by the host rules, one lane and one action at a time:
    the legal moves after which the last full line is the mover's."""
    out = np.zeros((54, board.shape[-1]), dtype=bool)
    for b in range(board.shape[-1]):
        lane, p = board[:, :, b], int(player[b])
        for a in np.nonzero(rules_np.legal_mask(lane, p))[0]:
            after = rules_np.apply_action(lane, p, int(a))
            out[a, b] = rules_np.line_winner(after) == rules_np.player_sign(p)
    return out


def positions(case: str, gen: torch.Generator):
    if case == "terminal":
        return terminal_positions(256, gen)
    return game_positions(256, int(case), gen)


@pytest.mark.parametrize("case", ["0", "3", "9", "40", "terminal"])
def test_plain_version_follows_the_rules(case):
    """Random-game positions at depths 0, 3, 9 and 40 and boards just won,
    both movers: the plain version's bools are the rules' move and fold."""
    gen = torch.Generator().manual_seed(SEED + len(case))
    board, player = positions(case, gen)
    got = wins.winning_actions(board, player)
    assert got.dtype == torch.bool and got.shape == (54, board.shape[-1])
    np.testing.assert_array_equal(got.numpy(), rules_wins(board.numpy(), player.numpy()))
    if case in ("9", "40", "terminal"):
        assert bool(got.any())


# ---------------------------------------------------------------------------
# hand-built boards: a lift reveals a line
# ---------------------------------------------------------------------------
def board_of(pieces) -> np.ndarray:
    """int8[3, 9] from (signed id, cell) pairs; id p sits on level (|p|-1)//2."""
    board = np.zeros((3, 9), dtype=np.int8)
    for piece, cell in pieces:
        board[(abs(piece) - 1) // 2, cell] = piece
    return board


def action(piece: int, cell: int) -> int:
    return 9 * (piece - 1) + cell


# (board for mover 0, {action: wins}).  The mover's large piece 5 covers
# the opponent's small piece on cell 2; lifting it shows what lies under.
REVEALS = {
    # the opponent's line (0, 1, 2) appears; the mover completes none
    "opponent_line": (board_of([(-1, 2), (5, 2), (-3, 0), (-4, 1)]),
                      {action(5, 4): False, action(5, 8): False, action(6, 4): False}),
    # the opponent's line 0 appears, the mover completes line 2 (6, 7, 8):
    # the later line is the mover's, so the move wins; piece 6 from the
    # hand completes line 2 with nothing revealed
    "mover_line_after": (board_of([(-1, 2), (5, 2), (-3, 0), (-4, 1), (1, 6), (2, 7)]),
                         {action(5, 8): True, action(6, 8): True, action(5, 4): False}),
    # the opponent's line 5 (2, 5, 8) appears, the mover completes line 3
    # (0, 3, 6): the later line is the opponent's, so the move does not win;
    # piece 6 from the hand onto cell 6 wins
    "opponent_line_after": (board_of([(-1, 2), (5, 2), (-3, 5), (-4, 8), (1, 0), (2, 3)]),
                            {action(5, 6): False, action(6, 6): True}),
    # the mover's own small piece under its large one: its line (0, 1, 2)
    # stands before and after the lift, so every move of the large piece
    # wins (the board is won already)
    "own_line": (board_of([(1, 2), (5, 2), (3, 0), (4, 1), (-5, 4)]),
                 {action(5, 3): True, action(5, 8): True, action(5, 4): False}),
}


@pytest.mark.parametrize("mover", [0, 1])
@pytest.mark.parametrize("case", sorted(REVEALS))
def test_lift_reveals_a_line(case, mover):
    """The plain version on the hand-built boards, for either mover (the
    other player's board is the same with the signs flipped): the named
    actions win or not as the last full line says, and every action
    agrees with the rules."""
    board, expect = REVEALS[case]
    board = board if mover == 0 else -board
    for a in expect:
        assert rules_np.legal_mask(board, mover)[a] or not expect[a], (case, a)
    lanes = torch.from_numpy(board[..., None].copy()).contiguous()
    player = torch.tensor([mover], dtype=torch.int32)
    got = wins.winning_actions(lanes, player)[:, 0].numpy()
    assert {a: bool(got[a]) for a in expect} == expect
    np.testing.assert_array_equal(got, rules_wins(board[..., None], np.array([mover]))[:, 0])


# ---------------------------------------------------------------------------
# a numpy model of csrc/wins.cu's bitboard algebra
# ---------------------------------------------------------------------------
def test_kernel_lines_are_the_rules_lines():
    """The nine-bit line masks of csrc/bitboard.cu, in the source's order,
    are ``WIN_LINES_NP``'s lines in theirs, and the kernels that fold lines
    (rollout.cu, wins.cu) take that table and hold none of their own."""
    table = r"(?:case \d|default): return 0x([0-9A-Fa-f]+)u;"
    found = re.findall(table, (CSRC / "bitboard.cu").read_text())
    assert [int(h, 16) for h in found] == LINES
    for kernel in ("rollout.cu", "wins.cu"):
        text = (CSRC / kernel).read_text()
        assert '#include "bitboard.cu"' in text and "full_lines(" in text, kernel
        assert not re.findall(table, text), kernel


def kernel_model(board: np.ndarray, player: np.ndarray) -> np.ndarray:
    """wins_kernel step by step on tests/torch_bitboard.py's words."""
    batch = board.shape[-1]
    sign = np.where(player == 0, 1, -1)
    v = board.astype(np.int32) * sign
    own = [sum(np.where(v[l, c] > 0, U32(1 << c), U32(0)) for c in range(9)) for l in range(3)]
    opp = [sum(np.where(v[l, c] < 0, U32(1 << c), U32(0)) for c in range(9)) for l in range(3)]
    occ, a0, a1 = words(board, sign)
    legal = mask_rows(action_mask(*legal_set(a0, a1, occ)))

    out = np.zeros((54, batch), dtype=bool)
    for p in range(6):
        l = p >> 1
        at = ((a1 if p & 1 else a0) >> U32(STRIDE * l)) & U32(0x1FF)
        o = list(own)
        o[l] = o[l] & ~at
        occ2 = o[2] | opp[2]
        occ12 = occ2 | o[1] | opp[1]
        t_own = o[2] | (o[1] & ~occ2) | (o[0] & ~occ12)
        t_opp = opp[2] | (opp[1] & ~occ2) | (opp[0] & ~occ12)
        full_own, full_opp = full_lines(t_own), full_lines(t_opp)
        for c in range(9):
            a = 9 * p + c
            mine = full_own.copy()
            through = 0
            for i, line in enumerate(LINES):
                if line >> c & 1:
                    rest = U32(line & ~(1 << c))
                    mine |= np.where(t_own & rest == rest, U32(1 << i), U32(0))
                    through |= 1 << i
            theirs = full_opp & ~U32(through)
            out[a] = legal[a] & (mine > theirs)
    return out


@pytest.mark.parametrize("case", ["0", "5", "40", "terminal", "reveals"])
def test_kernel_model_matches_plain_version(case):
    """The kernel's lifts, top masks and line words, as a numpy model, give
    the plain version's bools on every lane."""
    gen = torch.Generator().manual_seed(SEED + 7 * len(case))
    if case == "reveals":
        boards = [b for b, _ in REVEALS.values()]
        board = torch.from_numpy(np.stack(boards + [-b for b in boards], -1)).contiguous()
        player = torch.tensor([0] * len(boards) + [1] * len(boards), dtype=torch.int32)
    elif case == "terminal":
        board, player = terminal_positions(1500, gen)
    else:
        board, player = game_positions(1500, int(case), gen)
    plain = wins.winning_actions_plain(board, player)
    np.testing.assert_array_equal(kernel_model(board.numpy(), player.numpy()), plain.numpy())


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------
@pytest.fixture
def empty_table():
    profiling.TABLE.reset()
    yield
    profiling.TABLE.reset()


def test_tracing_counts_the_plain_rows(tmp_path, empty_table):
    """Under ``profiling.trace`` each call inside a span adds B to
    ``wins.plain_rows``; with tracing off nothing is counted."""
    board, player = game_positions(96, 4, torch.Generator().manual_seed(SEED))
    with profiling.annotate("root"):
        wins.winning_actions(board, player)
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("root"):
            wins.winning_actions(board, player)
            wins.winning_actions(board[..., :32].contiguous(), player[:32].contiguous())
    assert profiling.span_table()["counters"] == {"wins.plain_rows": 96 + 32}


def test_empty_batch():
    board = torch.zeros((3, 9, 0), dtype=torch.int8)
    out = wins.winning_actions(board, torch.zeros(0, dtype=torch.int32))
    assert out.dtype == torch.bool and out.shape == (54, 0)


@pytest.mark.parametrize("bad", ["dtype", "shape", "player", "strided", "device"])
def test_wrapper_rejects_bad_inputs(bad):
    board = torch.zeros((3, 9, 8), dtype=torch.int8)
    player = torch.zeros(8, dtype=torch.int32)
    if bad == "dtype":
        board = board.int()
    elif bad == "shape":
        board = board.reshape(27, 8)
    elif bad == "player":
        player = player.long()
    elif bad == "strided":
        board = torch.zeros((3, 9, 16), dtype=torch.int8)[..., ::2]
    else:
        board, player = board.to("meta"), player.to("meta")
    with pytest.raises(ValueError):
        wins.winning_actions(board, player)


# ---------------------------------------------------------------------------
# the kernel on a card
# ---------------------------------------------------------------------------
@pytest.mark.card
@pytest.mark.parametrize("batch", [0, 1, 4099, 524_288])
def test_kernel_equals_plain_version_on_the_card(batch, tmp_path, empty_table):
    """The kernel's bools equal the plain version's bit for bit on
    random-game positions at every depth, boards just won and the
    hand-built reveals; the launch counter counts (none at B = 0), and
    while tracing ``wins.kernel_rows`` counts B."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    boards = [b for b, _ in REVEALS.values()]
    special = torch.from_numpy(np.stack(boards + [-b for b in boards], -1)).to(dev)
    special_player = torch.tensor([0] * len(boards) + [1] * len(boards), dtype=torch.int32,
                                  device=dev)
    if batch > 2 * len(boards):
        ended, ended_player = terminal_positions(batch // 4, gen)
        board, player = game_positions(batch - ended.shape[-1] - special.shape[-1], 37, gen)
        board = torch.cat([board, ended, special], -1).contiguous()
        player = torch.cat([player, ended_player, special_player]).contiguous()
    else:
        board, player = special[..., :batch].contiguous(), special_player[:batch].contiguous()
    assert board.shape[-1] == batch
    launches = wins.winning_actions.launches
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("root"):
            kernel = wins.winning_actions(board, player)
    assert wins.winning_actions.launches == launches + (batch > 0)
    assert profiling.span_table()["counters"] == {"wins.kernel_rows": batch}
    assert kernel.shape == (54, batch)
    assert torch.equal(kernel, wins.winning_actions_plain(board, player))
