"""Branch-free Gobblet rules as torch tensor code, over a leading batch.

Port of ``gobblet_rl_tpu/core/rules.py``.  Every function takes ``board
int8[..., 3, 9]`` (and ``player``/``action`` of shape ``[...]``), so one
function serves a single env and a batch: the JAX module's ``batched_*``
``vmap``s are the same functions here.  Outputs follow the inputs' device;
``empty_board(device=None)`` means the CUDA card, or raise.

Semantics, with the reference's quirks:

* same-cell replacement is illegal (the size must strictly grow);
* gobbling one's own piece is legal (the covered test ignores colour);
* a covered piece cannot move;
* an illegal ``apply_action`` is a silent no-op;
* the winner is the LAST matching line in ``WIN_LINES`` order.

Actions lie in [0, 54).  ``board * sign`` stays in int8, as in JAX.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from gobblet_rl_torch.core import types as T
from gobblet_rl_torch.device import resolve_device

_TABLES = {
    "A_POS": T.ACTION_POS_NP, "A_PIECE": T.ACTION_PIECE_NP, "A_SIZE": T.ACTION_SIZE_NP,
    "P_LEVEL": T.PIECE_LEVEL_NP, "WIN_LINES": T.WIN_LINES_NP,
    "PIECE_IDS": np.arange(1, T.NUM_PIECES + 1, dtype=np.int8),
}


@functools.lru_cache(maxsize=None)
def _table(name: str, device: torch.device) -> torch.Tensor:
    """A static lookup table as a tensor on ``device`` (one copy each)."""
    arr = _TABLES[name]
    return torch.from_numpy(arr.astype(np.int64 if arr.dtype == np.int32 else arr.dtype)).to(device)


def empty_board(device=None) -> torch.Tensor:
    return torch.zeros((T.NUM_LEVELS, T.NUM_CELLS), dtype=torch.int8,
                       device=resolve_device(device))


def player_sign(player: torch.Tensor) -> torch.Tensor:
    """int8: +1 for agent 0, -1 for agent 1."""
    return torch.where(torch.as_tensor(player) == 0, 1, -1).to(torch.int8)


def covered(board: torch.Tensor) -> torch.Tensor:
    """bool[..., 3, 9]: the pieces gobbled by a larger one (colour-blind, so
    self-gobbling locks the piece underneath; large pieces are never
    covered)."""
    occ = board != 0
    c0 = occ[..., 0, :] & (occ[..., 1, :] | occ[..., 2, :])
    c1 = occ[..., 1, :] & occ[..., 2, :]
    return torch.stack([c0, c1, torch.zeros_like(c1)], dim=-2)


def flatboard(board: torch.Tensor) -> torch.Tensor:
    """int8[..., 9]: the signed id of the topmost piece per cell.

    Piece ids grow with level, so the level argmax of ``|board|`` (the first
    maximum, as ``jnp.argmax``) is the topmost occupied level; an empty
    stack gives level 0 and so 0.  On invalid boards this differs from the
    lane-major engine's 3-way select, and follows JAX's ``flatboard``."""
    top_level = board.abs().argmax(dim=-2, keepdim=True)           # [..., 1, 9]
    return board.gather(-2, top_level).squeeze(-2)


def _piece_rows(board: torch.Tensor, sign: torch.Tensor):
    """(own pieces positive on each piece's level [..., 6, 9], presence of
    each own piece 1..6 [..., 6, 9])."""
    dev = board.device
    own = board * sign[..., None, None]                            # int8
    rows = own.index_select(-2, _table("P_LEVEL", dev))            # [..., 6, 9]
    return rows, rows == _table("PIECE_IDS", dev)[:, None]


def _top_size(flat: torch.Tensor) -> torch.Tensor:
    """int32 size of the topmost piece, 0 if empty."""
    return (flat.abs().to(torch.int32) + 1) // 2


def legal_mask(board: torch.Tensor, player: torch.Tensor) -> torch.Tensor:
    """bool[..., 54]: the full legal mask of ``player``."""
    dev = board.device
    _, pres = _piece_rows(board, player_sign(player).to(dev))
    placed = pres.any(dim=-1)                                      # [..., 6]
    loc = pres.to(torch.uint8).argmax(dim=-1, keepdim=True)        # [..., 6, 1]
    cov_rows = covered(board).index_select(-2, _table("P_LEVEL", dev))
    piece_frozen = placed & cov_rows.gather(-1, loc).squeeze(-1)   # covered: immovable

    flat = flatboard(board)
    a_pos = _table("A_POS", dev)
    flat_a = flat.index_select(-1, a_pos)                          # [..., 54]
    target_ok = (flat_a == 0) | (_table("A_SIZE", dev) > _top_size(flat_a))
    return target_ok & ~piece_frozen.index_select(-1, _table("A_PIECE", dev) - 1)


def _decode(action: torch.Tensor):
    """(cell, piece 1..6, level 0..2) of ``action`` (int64)."""
    action = action.to(torch.int64)
    piece = action // T.NUM_CELLS + 1
    return action % T.NUM_CELLS, piece, (piece + 1) // 2 - 1


def is_legal(board: torch.Tensor, player: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """bool[...]: the legality of one action per env."""
    action = torch.as_tensor(action, device=board.device)
    pos, piece, level = _decode(action)
    size = level + 1
    sign = player_sign(player).to(board.device)
    idx = level[..., None, None].expand(*level.shape, 1, T.NUM_CELLS)
    row = board.gather(-2, idx).squeeze(-2) * sign[..., None]      # int8[..., 9]
    pres = row == piece.to(torch.int8)[..., None]
    placed = pres.any(dim=-1)
    loc = pres.to(torch.uint8).argmax(dim=-1, keepdim=True)
    cov_row = covered(board).gather(-2, idx).squeeze(-2)
    frozen = placed & cov_row.gather(-1, loc).squeeze(-1)

    top = flatboard(board).gather(-1, pos[..., None]).squeeze(-1)
    target_ok = (top == 0) | (size > _top_size(top))
    return target_ok & ~frozen


def apply_action(board: torch.Tensor, player: torch.Tensor, action: torch.Tensor,
                 legal: torch.Tensor | None = None) -> torch.Tensor:
    """Play a move; a silent no-op where it is illegal.  Pass ``legal`` when
    the caller has it already."""
    action = torch.as_tensor(action, device=board.device)
    if legal is None:
        legal = is_legal(board, player, action)
    pos, piece, level = _decode(action)
    signed = (piece * player_sign(player).to(board.device)).to(torch.int8)[..., None, None]
    lifted = torch.where(board == signed, 0, board)
    dev = board.device
    place = ((torch.arange(T.NUM_LEVELS, device=dev)[:, None] == level[..., None, None])
             & (torch.arange(T.NUM_CELLS, device=dev) == pos[..., None, None]))
    played = torch.where(place, signed, lifted)
    return torch.where(torch.as_tensor(legal, device=dev)[..., None, None], played, board)


def line_winner(board: torch.Tensor) -> torch.Tensor:
    """int8[...]: 0 no winner, +1 agent 0, -1 agent 1.  When both players
    complete lines in one move (by uncovering), the LAST line in
    ``WIN_LINES`` order decides."""
    lines = _table("WIN_LINES", board.device)
    vals = flatboard(board)[..., lines]                            # [..., 8, 3]
    lw = (vals > 0).all(dim=-1).to(torch.int8) - (vals < 0).all(dim=-1).to(torch.int8)
    nz = lw != 0
    last = (lines.shape[0] - 1) - nz.flip(-1).to(torch.uint8).argmax(dim=-1, keepdim=True)
    return torch.where(nz.any(dim=-1), lw.gather(-1, last).squeeze(-1), 0).to(torch.int8)


def board_invariants_ok(board: torch.Tensor) -> torch.Tensor:
    """bool[...]: every signed piece id appears at most once on its level,
    and every piece sits on its own level."""
    dev = board.device
    rows = board.index_select(-2, _table("P_LEVEL", dev))          # [..., 6, 9]
    ids = _table("PIECE_IDS", dev)[:, None]
    pos_counts = (rows == ids).sum(dim=-1)
    neg_counts = (rows == -ids).sum(dim=-1)
    on_level = (board.abs().to(torch.int64) + 1) // 2 - 1 == torch.arange(3, device=dev)[:, None]
    level_ok = ((board == 0) | on_level).flatten(-2).all(dim=-1)
    return (pos_counts <= 1).all(dim=-1) & (neg_counts <= 1).all(dim=-1) & level_ok


batched_legal_mask = legal_mask
batched_apply_action = apply_action
batched_line_winner = line_winner
batched_flatboard = flatboard
