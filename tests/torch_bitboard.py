"""A numpy model of the packed-bitboard board format that the port's CUDA
kernels share (``gobblet_rl_torch/kernels/csrc/bitboard.cu``): the words,
the legal set, its 54-bit action mask and the full-line words, on uint32
words with the batch last.  The kernels' tests build their models from it.
Imports no JAX, so the card tests that import it run where JAX is not
installed."""

import numpy as np

from gobblet_rl_torch.core.types import WIN_LINES_NP

U32 = np.uint32
STRIDE = 10
CELLS = sum(0x1FF << STRIDE * lv for lv in range(3))
GUARDS = CELLS + sum(1 << STRIDE * lv for lv in range(3))
LINES = [sum(1 << int(c) for c in line) for line in WIN_LINES_NP]


def spread(x):
    """Fields of ``x`` (10 bits apart) that are non-zero become 0x1FF, others 0."""
    h = (x + U32(CELLS)) & U32(GUARDS)
    return h - (h >> U32(9))


def words(board, sign):
    """``(occ, a0, a1)``, uint32[B], of ``board`` (int8[3, 9, B] or [27, B])
    as the mover of ``sign`` (int[B], 1 where player 0 moves) sees it: every
    level's occupancy and the mover's words, word k holding piece id
    2l+1+k's cells at bit 10*l."""
    v = board.reshape(3, 9, -1).astype(np.int32) * sign
    occ, a0, a1 = (np.zeros(v.shape[-1], U32) for _ in range(3))
    for lv in range(3):
        for c in range(9):
            bit = U32(1 << (STRIDE * lv + c))
            occ |= np.where(v[lv, c] != 0, bit, U32(0))
            a0 |= np.where(v[lv, c] == 2 * lv + 1, bit, U32(0))
            a1 |= np.where(v[lv, c] == 2 * lv + 2, bit, U32(0))
    return occ, a0, a1


def above(occ):
    """Each level's field holds the cells covered by a higher level."""
    return (occ >> U32(STRIDE)) | (occ >> U32(2 * STRIDE))


def legal_set(a0, a1, occ):
    """``(leg0, leg1)``: free cells per level, minus the fields of the
    mover's covered ids."""
    cover = above(occ)
    free = ~(occ | cover) & U32(CELLS)
    return free & ~spread(a0 & cover), free & ~spread(a1 & cover)


def action_mask(leg0, leg1):
    """uint64[B]: bit a for action a (piece a // 9 + 1 onto cell a % 9)."""
    mask = np.zeros(leg0.shape, np.uint64)
    for lv in range(3):
        for k, leg in enumerate((leg0, leg1)):
            field = (leg >> U32(STRIDE * lv)) & U32(0x1FF)
            mask |= field.astype(np.uint64) << np.uint64(18 * lv + 9 * k)
    return mask


def mask_rows(mask):
    """bool[54, B] of the uint64[B] action mask."""
    return ((mask[None] >> np.arange(54, dtype=np.uint64)[:, None]) & np.uint64(1)).astype(bool)


def full_lines(m):
    """uint32: bit i where line i of ``WIN_LINES_NP`` is full in the 9-bit
    masks ``m``."""
    return sum(np.where(m & U32(line) == U32(line), U32(1 << i), U32(0))
               for i, line in enumerate(LINES))
