"""Port parity for the fused rollout: the plain version of the CUDA kernel
(gobblet_rl_torch.kernels.rollout) against a JAX loop built from the Pallas
kernel's own helpers, bit for bit under one injected numpy field; the
Philox generator against known answers and its five-draws-a-block layout;
a numpy model of the kernel's bitboard algebra (legal mask, line masks,
packed keys, the whole ply) against the Pallas helpers and the plain
version; and the CPU dispatch of the wrapper.  The CUDA kernel itself is
held against the plain version on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gobblet_rl_torch.kernels import rollout as R
from gobblet_rl_torch.ops import batched_core as tbc
from gobblet_rl_tpu.ops import pallas_rollout as pr
from tests.test_pallas import _valid_board
from tests.torch_bitboard import (STRIDE, U32, above, action_mask, full_lines, legal_set,
                                  mask_rows, spread, words)

CPU = torch.device("cpu")


@jax.jit
def jax_rollout(board27, cur, field):
    """pallas_rollout._rollout_kernel's ply (lines 103-137) as a scan over a
    uint32[steps, 54, B] field in place of the TPU PRNG."""

    def body(carry, bits):
        board, cur, eps, w1, w2 = carry                      # [27,B], [1,B]
        sign = jnp.where(cur == 0, 1, -1)
        mask = pr._legal_mask(board, sign)
        draws24 = (bits >> 8).astype(jnp.int32).astype(jnp.float32)
        draws = jnp.where(mask, draws24, -1.0)
        maxv = jnp.max(draws, axis=0, keepdims=True)
        a_ids = jax.lax.broadcasted_iota(jnp.int32, draws.shape, 0)
        action = jnp.min(jnp.where(mask & (draws == maxv), a_ids, 99), axis=0, keepdims=True)
        pos = action % 9
        piece = action // 9 + 1
        level = (piece + 1) // 2 - 1
        signed = piece * sign
        row_ids = jax.lax.broadcasted_iota(jnp.int32, board.shape, 0)
        board = jnp.where(row_ids == level * 9 + pos, signed,
                          jnp.where(board == signed, 0, board))
        win = pr._winner(pr._flat(board))
        done = win != 0
        eps = eps + jnp.sum(done.astype(jnp.int32))
        w1 = w1 + jnp.sum((win == 1).astype(jnp.int32))
        w2 = w2 + jnp.sum((win == -1).astype(jnp.int32))
        board = jnp.where(done, 0, board)
        cur = jnp.where(done, 0, 1 - cur)
        return (board, cur, eps, w1, w2), None

    zero = jnp.int32(0)
    (board, cur, eps, w1, w2), _ = jax.lax.scan(
        body, (board27.astype(jnp.int32), cur[None].astype(jnp.int32), zero, zero, zero), field)
    return board.astype(jnp.int8), cur[0], eps, w1, w2


def start_state(B, plies, seed):
    """Mid-game start states from the engine rollout (numpy Gumbel field)."""
    g = np.random.default_rng(seed).gumbel(size=(plies, 54, B)).astype(np.float32)
    s, _ = tbc.rollout_random(tbc.reset_planes(B, CPU), None, plies, torch.from_numpy(g))
    return s.board, s.current


def run_both(B, steps, seed, start_plies=5):
    board, cur = start_state(B, start_plies, seed)
    field = np.random.default_rng(seed + 100).integers(0, 2**32, (steps, 54, B), dtype=np.uint32)
    jb, jc, je, j1, j2 = jax_rollout(jnp.asarray(board.numpy().reshape(27, B)),
                                     jnp.asarray(cur.numpy()), jnp.asarray(field))
    tb, tc, ts = R.rollout_random_fused_plain(board, cur, steps, torch.from_numpy(field))
    return (np.asarray(jb).reshape(3, 9, B), np.asarray(jc), (int(je), int(j1), int(j2))), \
        (tb, tc, ts)


@pytest.mark.parametrize("B,steps,seed", [(256, 40, 0), (300, 24, 1), (512, 64, 2)])
def test_plain_version_matches_pallas_helpers_loop(B, steps, seed):
    (jb, jc, jstats), (tb, tc, ts) = run_both(B, steps, seed)
    assert tb.dtype == torch.int8 and tc.dtype == torch.int32
    np.testing.assert_array_equal(tb.numpy(), jb)
    np.testing.assert_array_equal(tc.numpy(), jc)
    assert (int(ts["episodes"]), int(ts["wins_p1"]), int(ts["wins_p2"])) == jstats


def test_plain_version_invariants():
    B = 512
    board, cur = tbc.reset_planes(B, CPU).board, torch.zeros(B, dtype=torch.int32)
    field = np.random.default_rng(3).integers(0, 2**32, (64, 54, B), dtype=np.uint32)
    tb, tc, stats = R.rollout_random_fused_plain(board, cur, 64, torch.from_numpy(field))
    eps, w1, w2 = (int(stats[k]) for k in ("episodes", "wins_p1", "wins_p2"))
    assert eps == w1 + w2
    assert eps > B
    assert 0.4 < w1 / eps < 0.7
    assert set(np.unique(tc.numpy())) <= {0, 1}
    for env in range(B):
        _valid_board(tb.numpy()[:, :, env].reshape(27))


def test_beside_interpreted_pallas_kernel():
    """The interpreted TPU kernel and the port from one start state: their
    random streams differ, so only the invariants are compared."""
    B, steps = 512, 12
    board, cur = start_state(B, 3, 4)
    pb, pc, pstats = pr.rollout_random_pallas(
        jnp.asarray(board.numpy()), jnp.asarray(cur.numpy()), steps, 0,
        pltpu.InterpretParams(), 256)
    tb, tc, tstats = R.rollout_random_fused(board, cur, steps, seed=0)
    for b, c, stats in ((np.asarray(pb), np.asarray(pc), pstats),
                        (tb.numpy(), tc.numpy(), tstats)):
        assert int(stats["episodes"]) == int(stats["wins_p1"]) + int(stats["wins_p2"])
        assert set(np.unique(c)) <= {0, 1}
        for env in range(0, B, 7):
            _valid_board(b[:, :, env].reshape(27))
    assert int(tstats["episodes"]) > 0


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    """Philox4x32-10 known-answer vectors (Random123's kat_vectors)."""
    c = [torch.tensor([x], dtype=torch.int64) for x in ctr]
    got = R.philox4x32_10(*c, key[0], torch.tensor([key[1]], dtype=torch.int64))
    assert tuple(int(x[0]) for x in got) == want


def test_philox_field_layout():
    """Block (ply, chunk) keyed on (seed, env) holds five 24-bit draws at bit
    offsets 0, 24, 48, 72, 96 of the 128-bit number w:z:y:x; draw j is action
    5*chunk + j, and the field word is draw << 8."""
    seed, steps, B = 12345, 3, 5
    field = R.philox_field(seed, steps, B, CPU)
    assert field.dtype == torch.uint32 and tuple(field.shape) == (steps, 54, B)
    f = field.view(torch.int32).numpy().view(np.uint32)
    for t in range(steps):
        for env in range(B):
            for chunk in range(11):
                c = [torch.tensor([x], dtype=torch.int64) for x in (t, chunk, 0, 0)]
                words = R.philox4x32_10(*c, seed, torch.tensor([env], dtype=torch.int64))
                big = sum(int(w[0]) << (32 * i) for i, w in enumerate(words))
                for j in range(5):
                    a = 5 * chunk + j
                    if a < 54:
                        draw = (big >> (24 * j)) & 0xFFFFFF
                        assert int(f[t, a, env]) == draw << 8


# A numpy model of the kernel's bitboard algebra (csrc/rollout.cu, items 1-3
# of its note, on tests/torch_bitboard.py's words), held against the Pallas
# kernel's helpers.
def to_words(board27, sign):
    """Mover's words a0, a1 and the other's b0, b1 (uint32 [B])."""
    return words(board27, sign)[1:] + words(board27, -sign)[1:]


def model_legal(a0, a1, b0, b1):
    """bool[54, B] from the words: free cells per level minus frozen ids."""
    return mask_rows(action_mask(*legal_set(a0, a1, a0 | a1 | b0 | b1)))


def model_top(own, cover):
    vis = own & ~cover
    return (vis | (vis >> U32(STRIDE)) | (vis >> U32(2 * STRIDE))) & U32(0x1FF)


def model_key(draw24, a):
    """The kernel's packed key: draw in bits 8-31, 255 - code(a) below."""
    code = 64 * (a // 18) + 32 * ((a // 9) % 2) + a % 9
    return (draw24.astype(np.uint64) << np.uint64(8)) | np.uint64(255 - code)


@pytest.mark.parametrize("plies,seed", [(3, 11), (14, 12), (40, 13)])
def test_bitboard_legal_mask_matches_pallas(plies, seed):
    """Occupancy, free-by-size and frozen from the words equal _legal_mask,
    and each player's topmost cells equal _flat's, on reachable states."""
    board, cur = start_state(128, plies, seed)
    b27 = board.numpy().reshape(27, -1).astype(np.int32)
    sign = np.where(cur.numpy() == 0, 1, -1)
    a0, a1, b0, b1 = to_words(b27, sign)
    want = np.asarray(pr._legal_mask(jnp.asarray(b27), jnp.asarray(sign[None])))
    np.testing.assert_array_equal(model_legal(a0, a1, b0, b1), want)
    cover = above(a0 | a1 | b0 | b1)
    flat = np.asarray(pr._flat(jnp.asarray(b27))) * sign
    for own, sgn in ((a0 | a1, 1), (b0 | b1, -1)):
        top = model_top(own, cover)
        bits = sum((flat[c] * sgn > 0).astype(U32) << U32(c) for c in range(9))
        np.testing.assert_array_equal(top, bits)
    if plies == 40:  # deep states carry covered and frozen pieces
        assert (spread(a0 & cover) | spread(a1 & cover)).any()


def test_line_masks_match_winner_exhaustively():
    """All 3**9 top-owner patterns: _winner's last-line-wins fold equals
    comparing the two players' completed-line masks."""
    top = np.array(np.meshgrid(*[[-1, 0, 1]] * 9, indexing="ij")).reshape(9, -1).astype(np.int32)
    want = np.asarray(pr._winner(jnp.asarray(top)))[0]
    lx = full_lines(sum((top[c] > 0).astype(U32) << U32(c) for c in range(9)))
    lo = full_lines(sum((top[c] < 0).astype(U32) << U32(c) for c in range(9)))
    assert not (lx & lo).any()
    np.testing.assert_array_equal(np.where(lx > lo, 1, np.where(lo > lx, -1, 0)), want)


def test_packed_key_max_is_max_draw_lowest_index():
    """The max of the legal actions' packed keys decodes to the plain
    version's action (max draw, lowest index on ties), ties included."""
    rng = np.random.default_rng(21)
    B = 4096
    legal = rng.random((54, B)) < 0.3
    legal[rng.integers(0, 54, B), np.arange(B)] = True
    for hi in (4, 2**24):  # few distinct draws force ties
        draw = rng.integers(0, hi, (54, B))
        d = np.where(legal, draw, -1)
        want = np.argmax(d == d.max(axis=0), axis=0)
        keys = np.where(legal, model_key(draw, np.arange(54)[:, None]), np.uint64(0))
        code = 255 - (keys.max(axis=0) & np.uint64(255)).astype(np.int64)
        got = 18 * (code >> 6) + 9 * ((code >> 5) & 1) + (code & 31)
        np.testing.assert_array_equal(got, want)


def model_rollout(board, cur, field):
    """The kernel's ply loop on the words (numpy), for a [steps, 54, B] field."""
    b27 = board.reshape(27, -1).astype(np.int32)
    cur = cur.astype(np.int64).copy()
    a0, a1, b0, b1 = to_words(b27, np.where(cur == 0, 1, -1))
    eps = w1 = 0
    for bits in field:
        keys = np.where(model_legal(a0, a1, b0, b1),
                        model_key(bits >> 8, np.arange(54)[:, None]), np.uint64(0))
        code = (~keys.max(axis=0) & np.uint64(255)).astype(np.int64)
        lv, k, cell = code >> 6, (code >> 5) & 1, code & 31
        clear = ~(U32(0x1FF) << (STRIDE * lv).astype(U32))
        bit = U32(1) << (STRIDE * lv + cell).astype(U32)
        a1 = np.where(k == 1, (a1 & clear) | bit, a1)
        a0 = np.where(k == 0, (a0 & clear) | bit, a0)
        cover = above(a0 | a1 | b0 | b1)
        la, lb = full_lines(model_top(a0 | a1, cover)), full_lines(model_top(b0 | b1, cover))
        done = (la | lb) != 0
        eps += int(done.sum())
        w1 += int((done & ((la > lb) == (cur == 0))).sum())
        a0, a1, b0, b1 = (np.where(done, U32(0), w) for w in (b0, b1, a0, a1))
        cur = np.where(done, 0, 1 - cur)
    x = [np.where(cur == 0, p, q) for p, q in ((a0, b0), (a1, b1), (b0, a0), (b1, a1))]
    out = np.zeros_like(b27)
    for lv in range(3):
        for c in range(9):
            s = U32(STRIDE * lv + c)
            vals = (2 * lv + 1, 2 * lv + 2, -(2 * lv + 1), -(2 * lv + 2))
            for w, v in reversed(list(zip(x, vals))):
                out[9 * lv + c] = np.where((w >> s) & U32(1), v, out[9 * lv + c])
    return out.reshape(3, 9, -1).astype(np.int8), cur.astype(np.int32), (eps, w1, eps - w1)


@pytest.mark.parametrize("B,steps,seed,start_plies", [(256, 48, 31, 5), (200, 24, 32, 40)])
def test_bitboard_model_rollout_matches_plain_version(B, steps, seed, start_plies):
    """The kernel's whole ply (words, packed keys, line masks, swap and
    reset) modelled in numpy reproduces the plain version bit for bit."""
    board, cur = start_state(B, start_plies, seed)
    field = np.random.default_rng(seed).integers(0, 2**32, (steps, 54, B), dtype=np.uint32)
    mb, mc, mstats = model_rollout(board.numpy(), cur.numpy(), field)
    tb, tc, ts = R.rollout_random_fused_plain(board, cur, steps, torch.from_numpy(field))
    np.testing.assert_array_equal(mb, tb.numpy())
    np.testing.assert_array_equal(mc, tc.numpy())
    assert mstats == (int(ts["episodes"]), int(ts["wins_p1"]), int(ts["wins_p2"]))


def test_wrapper_takes_plain_path_on_cpu():
    B, steps = 200, 16
    board, cur = start_state(B, 4, 6)
    field = torch.from_numpy(
        np.random.default_rng(6).integers(0, 2**32, (steps, 54, B), dtype=np.uint32))
    before = R.rollout_random_fused.launches
    wb, wc, ws = R.rollout_random_fused(board, cur, steps, draws=field)
    pb, pc, ps = R.rollout_random_fused_plain(board, cur, steps, field)
    assert torch.equal(wb, pb) and torch.equal(wc, pc)
    assert all(int(ws[k]) == int(ps[k]) for k in ps)
    # without a field the CPU path draws the kernel's Philox words
    wb, wc, ws = R.rollout_random_fused(board, cur, steps, seed=9)
    pb, pc, ps = R.rollout_random_fused_plain(board, cur, steps,
                                              R.philox_field(9, steps, B, CPU))
    assert torch.equal(wb, pb) and torch.equal(wc, pc)
    assert all(int(ws[k]) == int(ps[k]) for k in ps)
    assert R.rollout_random_fused.launches == before  # no kernel on the CPU


@pytest.mark.parametrize("bad", ["board_dtype", "board_shape", "current_dtype",
                                 "draws_shape", "non_contiguous", "steps"])
def test_wrapper_rejects_bad_inputs(bad):
    B = 8
    board = torch.zeros((3, 9, B), dtype=torch.int8)
    cur = torch.zeros(B, dtype=torch.int32)
    draws, steps = None, 4
    if bad == "board_dtype":
        board = board.to(torch.int32)
    elif bad == "board_shape":
        board = torch.zeros((27, B), dtype=torch.int8)
    elif bad == "current_dtype":
        cur = cur.to(torch.int64)
    elif bad == "draws_shape":
        draws = torch.zeros((steps, 53, B), dtype=torch.int32)
    elif bad == "non_contiguous":
        board = torch.zeros((3, B, 9), dtype=torch.int8).transpose(1, 2)
    elif bad == "steps":
        steps = -1
    with pytest.raises(ValueError):
        R.rollout_random_fused(board, cur, steps, draws=draws)
