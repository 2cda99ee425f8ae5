"""Vectorized NumPy rules for host code (no tensor dispatch per call).

The port's own copy of ``gobblet_rl_tpu/core/rules_np.py``: the AEC env,
the ``Board`` facade and the host greedy policy call it.  Same semantics as
:mod:`gobblet_rl_torch.core.rules` (``tests/test_torch_rules.py`` holds both
to the JAX package's rules).
"""

from __future__ import annotations

import numpy as np

from gobblet_rl_torch.core import types as T

A_POS = T.ACTION_POS_NP
A_PIECE = T.ACTION_PIECE_NP
A_SIZE = T.ACTION_SIZE_NP
P_LEVEL = T.PIECE_LEVEL_NP
WIN_LINES = T.WIN_LINES_NP
_CELLS = np.arange(T.NUM_CELLS)


def empty_board() -> np.ndarray:
    return np.zeros((T.NUM_LEVELS, T.NUM_CELLS), dtype=np.int8)


def player_sign(player: int) -> int:
    return 1 if player == 0 else -1


def covered(board: np.ndarray) -> np.ndarray:
    """bool[3, 9]: the pieces gobbled by a larger one (color-blind)."""
    occ = board != 0
    return np.stack([
        occ[0] & (occ[1] | occ[2]),
        occ[1] & occ[2],
        np.zeros(T.NUM_CELLS, dtype=bool),
    ])


def flatboard(board: np.ndarray) -> np.ndarray:
    """Signed piece id of the topmost piece per cell."""
    top_level = np.argmax(np.abs(board), axis=0)
    return board[top_level, _CELLS]


def legal_mask(board: np.ndarray, player: int) -> np.ndarray:
    """bool[54]: the legal mask of ``player``, in one shot."""
    own = board * player_sign(player)
    rows = own[P_LEVEL]                                     # [6, 9]
    pres = rows == np.arange(1, T.NUM_PIECES + 1)[:, None]  # [6, 9]
    placed = pres.any(axis=1)
    loc = np.argmax(pres, axis=1)
    piece_frozen = placed & covered(board)[P_LEVEL, loc]

    flat = flatboard(board)
    top_size = (np.abs(flat).astype(np.int32) + 1) // 2
    target_ok = (flat[A_POS] == 0) | (A_SIZE > top_size[A_POS])
    return target_ok & ~piece_frozen[A_PIECE - 1]


def is_legal(board: np.ndarray, player: int, action: int) -> bool:
    if not 0 <= action < T.NUM_ACTIONS:
        return False
    return bool(legal_mask(board, player)[action])


def apply_action(board: np.ndarray, player: int, action: int) -> np.ndarray:
    """Pure move application; returns the input board when illegal."""
    if not is_legal(board, player, action):
        return board
    piece = action // T.NUM_CELLS + 1
    level = (piece + 1) // 2 - 1
    signed = piece * player_sign(player)
    out = np.where(board == signed, 0, board).astype(board.dtype)
    out[level, action % T.NUM_CELLS] = signed
    return out


def line_winner(board: np.ndarray) -> int:
    """0 / +1 / -1; the last matching line in ``WIN_LINES`` order decides."""
    vals = flatboard(board)[WIN_LINES]
    lw = (vals > 0).all(axis=1).astype(np.int8) - (vals < 0).all(axis=1).astype(np.int8)
    nz = np.nonzero(lw)[0]
    return int(lw[nz[-1]]) if len(nz) else 0
