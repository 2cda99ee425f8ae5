"""Debug-mode invariant checks of the lane-major engine.

Port of ``gobblet_rl_tpu/ops/debug.py``.  The hot path stays assert-free;
these are pure predicates, and :func:`checked_step` is ``step_planes``
between checks that raise ``ValueError`` (in place of JAX's ``checkify``).
It reads the checks back to the host, a sync that a debug path can afford.
"""

from __future__ import annotations

import torch

from gobblet_rl_torch.ops import batched_core as bc


def planes_invariants(board: torch.Tensor) -> torch.Tensor:
    """bool[B]: the structural validity of each env of ``board`` int8[3, 9,
    B]: every signed piece id at most once and only on its level, no value
    outside [-6, 6]."""
    ok = torch.ones(board.shape[-1], dtype=torch.bool, device=board.device)
    for level in range(3):
        allowed = (2 * level + 1, 2 * level + 2)
        row = board[level]                                  # [9, B]
        abs_row = row.abs()
        ok &= ((row == 0) | (abs_row == allowed[0]) | (abs_row == allowed[1])).all(dim=0)
        for piece in allowed:
            for sign in (1, -1):
                ok &= (row == sign * piece).sum(dim=0) <= 1
    return ok


def state_invariants(state: bc.PlanesState) -> torch.Tensor:
    """bool[B]: board validity and the ranges of ``current`` and
    ``winner``."""
    ok = planes_invariants(state.board)
    ok &= (state.current == 0) | (state.current == 1)
    return ok & (state.winner.to(torch.int32).abs() <= 1)


def checked_step(state: bc.PlanesState, actions: torch.Tensor) -> bc.PlanesState:
    """``step_planes`` with the pre- and post-state checked; raises
    ``ValueError`` on a violated invariant."""
    if not bool(state_invariants(state).all()):
        raise ValueError("pre-step state invalid")
    if not bool(((actions >= 0) & (actions < 54)).all()):
        raise ValueError("action out of range")
    new_state = bc.step_planes(state, actions)
    if not bool(state_invariants(new_state).all()):
        raise ValueError("post-step state invalid")
    return new_state
