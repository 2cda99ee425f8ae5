"""The uniform legal draw (``gobblet_rl_torch.kernels.draw``): its plain
version on the CPU (legal, uniform, reproducible from the generator,
counted while tracing), a numpy model of the CUDA kernel's integer algebra
against the plain version, and, on a card, the kernel against the plain
version bit for bit.  Imports no JAX, so the card test runs where JAX is
not installed."""

import numpy as np
import pytest
import scipy.stats
import torch

from gobblet_rl_torch.kernels import draw
from gobblet_rl_torch.kernels.rollout import philox4x32_10
from gobblet_rl_torch.ops import batched_core as bc
from gobblet_rl_torch.utils import profiling
from tests.torch_bitboard import action_mask, legal_set, words

CPU = torch.device("cpu")
SEED = 2**33 + 17


def game_positions(batch: int, plies: int, gen: torch.Generator):
    """(board, current) after ``plies`` random plies with auto-reset, so the
    envs sit at every depth of a game."""
    state, _ = bc.rollout_random(bc.reset_planes(batch, gen.device), gen, plies)
    return state.board.contiguous(), state.current.contiguous()


def few_moves_board(free_cells: int) -> torch.Tensor:
    """int8[3, 9]: the other player's large piece on top of every cell but
    the first ``free_cells``, which hold its medium piece.  Only the
    mover's two large pieces can move there, so exactly ``2 * free_cells``
    actions are legal for either mover (the fewest a board allows above 0,
    since the two large pieces share their targets and nothing covers
    them).  Not a reachable position: there are only four large pieces."""
    board = torch.zeros((3, 9), dtype=torch.int8)
    board[2, free_cells:] = -5
    board[1, :free_cells] = -3
    return board


def special_positions() -> tuple[torch.Tensor, torch.Tensor]:
    """The empty board, boards with 0, 2 and 6 legal actions (mover 0), and
    the 2-action board with the signs flipped (mover 1)."""
    boards = [torch.zeros((3, 9), dtype=torch.int8)] + \
        [few_moves_board(f) for f in (0, 1, 3)] + [-few_moves_board(1)]
    return torch.stack(boards, dim=-1).contiguous(), torch.tensor([0, 0, 0, 0, 1],
                                                                   dtype=torch.int32)


def tile(board: torch.Tensor, current: torch.Tensor, n: int):
    return board.repeat(1, 1, n).contiguous(), current.repeat(n).contiguous()


def test_every_action_legal():
    """Random-game positions at every depth and the special boards: every
    drawn action is legal, and where none is, the action is 0."""
    gen = torch.Generator().manual_seed(SEED)
    for plies in (0, 3, 9, 40):
        board, cur = game_positions(1024, plies, gen)
        mask = bc.legal_mask_planes(board, cur)
        a = draw.random_legal_actions(board, cur, gen)
        assert a.dtype == torch.int32 and a.shape == (1024,)
        assert bool(mask[a.long(), torch.arange(1024)].all()), plies
    board, cur = tile(*special_positions(), 200)
    mask = bc.legal_mask_planes(board, cur)
    assert mask.sum(0)[:5].tolist() == [54, 0, 2, 6, 2]
    a = draw.random_legal_actions(board, cur, gen).long()
    legal = mask[a, torch.arange(a.shape[0])]
    none = mask.sum(0) == 0
    assert bool(legal[~none].all()) and bool((a[none] == 0).all())
    # the 2-action boards: either large piece onto cell 0, for either mover
    assert set(a[2::5].tolist()) == set(a[4::5].tolist()) == {36, 45}


@pytest.mark.parametrize("free_cells", [None, 3])
def test_draw_is_uniform(free_cells):
    """A chi-square test over 200,000 draws of one position, with a fixed
    seed: the empty board (54 legal) and a board with 6 legal actions."""
    n = 200_000
    board = torch.zeros((3, 9), dtype=torch.int8) if free_cells is None \
        else few_moves_board(free_cells)
    board = board[..., None].expand(3, 9, n).contiguous()
    cur = torch.zeros(n, dtype=torch.int32)
    legal = torch.nonzero(bc.legal_mask_planes(board[..., :1], cur[:1])[:, 0])[:, 0]
    a = draw.random_legal_actions(board, cur, torch.Generator().manual_seed(SEED))
    counts = torch.bincount(a.long(), minlength=54)
    assert int(counts.sum()) == int(counts[legal].sum()) == n
    result = scipy.stats.chisquare(counts[legal].numpy())
    assert result.pvalue > 1e-3, (len(legal), result)


def test_generator_state_decides_the_draw():
    """A cloned generator state gives the same actions; two calls in a row
    differ; each call advances the generator."""
    gen = torch.Generator().manual_seed(SEED)
    board, cur = game_positions(512, 7, gen)
    saved = gen.get_state()
    a = draw.random_legal_actions(board, cur, gen)
    after = gen.get_state()
    assert not torch.equal(saved, after)
    b = draw.random_legal_actions(board, cur, gen)
    assert not torch.equal(a, b)
    gen.set_state(saved)
    assert torch.equal(draw.random_legal_actions(board, cur, gen), a)
    assert torch.equal(gen.get_state(), after)


@pytest.fixture
def empty_table():
    profiling.TABLE.reset()
    yield
    profiling.TABLE.reset()


def test_tracing_counts_the_plain_rows(tmp_path, empty_table):
    """Under ``profiling.trace`` each call inside a span adds B to
    ``draw.plain_rows``; with tracing off nothing is counted."""
    gen = torch.Generator().manual_seed(SEED)
    board, cur = game_positions(96, 4, gen)
    with profiling.annotate("root"):
        draw.random_legal_actions(board, cur, gen)
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("root"):
            draw.random_legal_actions(board, cur, gen)
            draw.random_legal_actions(board[..., :32].contiguous(), cur[:32].contiguous(), gen)
    assert profiling.span_table()["counters"] == {"draw.plain_rows": 96 + 32}


@pytest.mark.parametrize("bad", ["dtype", "shape", "current", "strided"])
def test_wrapper_rejects_bad_inputs(bad):
    gen = torch.Generator()
    board = torch.zeros((3, 9, 8), dtype=torch.int8)
    cur = torch.zeros(8, dtype=torch.int32)
    if bad == "dtype":
        board = board.int()
    elif bad == "shape":
        board = board.reshape(27, 8)
    elif bad == "current":
        cur = cur.long()
    else:
        board = torch.zeros((3, 9, 16), dtype=torch.int8)[..., ::2]
    state = gen.get_state()
    with pytest.raises(ValueError):
        draw.random_legal_actions(board, cur, gen)
    assert torch.equal(gen.get_state(), state)


# ---------------------------------------------------------------------------
# a numpy model of csrc/draw.cu's integer algebra
# ---------------------------------------------------------------------------
def kernel_model(board: np.ndarray, current: np.ndarray, key: np.ndarray) -> np.ndarray:
    """draw_kernel step by step on tests/torch_bitboard.py's words, the
    product's high word by Python integers."""
    batch = board.shape[-1]
    occ, a0, a1 = words(board, np.where(current == 0, 1, -1))
    mask = action_mask(*legal_set(a0, a1, occ))

    k, ctr = (int(w) & (2**64 - 1) for w in key)
    env = torch.arange(batch, dtype=torch.int64)
    x, y, _, _ = philox4x32_10(env, torch.zeros_like(env), ctr & 0xFFFFFFFF, ctr >> 32,
                               k & 0xFFFFFFFF, k >> 32)
    out = np.zeros(batch, np.int32)
    for e in range(batch):
        m = int(mask[e])
        legal = bin(m).count("1")
        if legal == 0:
            continue
        r = (((int(y[e]) << 32) | int(x[e])) * legal) >> 64
        w, base = m & 0xFFFFFFFF, 0
        if r >= bin(w).count("1"):
            r -= bin(w).count("1")
            w, base = m >> 32, 32
        for half in (16, 8, 4, 2, 1):
            c = bin(w & ((1 << half) - 1)).count("1")
            if r >= c:
                r, w, base = r - c, w >> half, base + half
        out[e] = base
    return out


@pytest.mark.parametrize("plies", [0, 5, 40])
def test_kernel_model_matches_plain_version(plies):
    """The kernel's bitboard mask, 64-bit scaling and halving select, as a
    numpy model, give the plain version's actions, key for key (keys with
    the top bits set too)."""
    gen = torch.Generator().manual_seed(SEED + plies)
    board, cur = game_positions(1500, plies, gen)
    sb, sc = special_positions()
    board, cur = torch.cat([board, sb], -1).contiguous(), torch.cat([cur, sc]).contiguous()
    keys = [draw.draw_key(gen, CPU), torch.tensor([-1, -2**63], dtype=torch.int64)]
    for key in keys:
        plain = draw.random_legal_actions_plain(board, cur, key)
        model = kernel_model(board.numpy(), cur.numpy(), key.numpy())
        np.testing.assert_array_equal(plain.numpy(), model)


# ---------------------------------------------------------------------------
# the kernel on a card
# ---------------------------------------------------------------------------
@pytest.mark.card
@pytest.mark.parametrize("batch", [4099, 2_097_152])
def test_kernel_equals_plain_version_on_the_card(batch):
    """For the same generator state the kernel's actions equal the plain
    version's on the same key, bit for bit, on random-game positions at
    every depth and the special boards; the launch counter counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    board, cur = game_positions(batch - 5, 37, gen)
    sb, sc = special_positions()
    board = torch.cat([board, sb.to(dev)], -1).contiguous()
    cur = torch.cat([cur, sc.to(dev)]).contiguous()
    for _ in range(3):
        saved = gen.get_state()
        launches = draw.random_legal_actions.launches
        kernel = draw.random_legal_actions(board, cur, gen)
        assert draw.random_legal_actions.launches == launches + 1
        gen.set_state(saved)
        plain = draw.random_legal_actions_plain(board, cur, draw.draw_key(gen, dev))
        assert torch.equal(kernel, plain)
