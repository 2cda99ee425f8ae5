"""Sizes and per-action tables of the Gobblet engine (host numpy).

Board encoding, as in the JAX package's ``core/types.py``:

* the board is ``int8[3, 9]`` — ``board[level, pos]`` holds the signed piece
  id at cell ``pos`` (0-8, column-major) and stacking ``level``
  (0 small, 1 medium, 2 large);
* piece ids are 1..6 for player 0 and -1..-6 for player 1 (1-2 small,
  3-4 medium, 5-6 large), each id at most once;
* actions are ``Discrete(54)``: ``action = pos + 9 * (piece - 1)``.

``GobbletState`` is one env's state (``core/env.py`` batches it with a
leading axis); :func:`zeros_state` is a fresh start state in numpy.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np

NUM_CELLS = 9
NUM_LEVELS = 3
NUM_PIECES = 6
NUM_ACTIONS = NUM_CELLS * NUM_PIECES  # 54
NUM_AGENTS = 2
OBS_CHANNELS = 13  # 12 one-hot piece planes + the agent plane

_A = np.arange(NUM_ACTIONS)
ACTION_POS_NP = (_A % NUM_CELLS).astype(np.int32)                 # 0..8
ACTION_PIECE_NP = (_A // NUM_CELLS + 1).astype(np.int32)          # 1..6
ACTION_SIZE_NP = ((ACTION_PIECE_NP + 1) // 2).astype(np.int32)    # 1..3
ACTION_LEVEL_NP = (ACTION_SIZE_NP - 1).astype(np.int32)           # 0..2

_P = np.arange(1, NUM_PIECES + 1)
PIECE_SIZE_NP = ((_P + 1) // 2).astype(np.int32)                  # 1..3
PIECE_LEVEL_NP = (PIECE_SIZE_NP - 1).astype(np.int32)             # 0..2

# Win lines over the flat 3x3 board in the reference's scan order: three
# "vertical", three "horizontal", then the two diagonals.  The LAST matching
# line decides the winner, so the order is part of the rules.
WIN_LINES_NP = np.array(
    [
        [0, 1, 2], [3, 4, 5], [6, 7, 8],
        [0, 3, 6], [1, 4, 7], [2, 5, 8],
        [0, 4, 8], [2, 4, 6],
    ],
    dtype=np.int32,
)


class GobbletState(NamedTuple):
    """Env state as fixed-shape arrays; a leading batch axis batches it.
    Torch tensors in :mod:`gobblet_rl_torch.core.env`, numpy arrays from
    :func:`zeros_state`."""

    board: Any        # int8[..., 3, 9] signed piece ids
    current: Any      # int32[...], the agent to move (0 or 1)
    turn: Any         # int32[...], legal plies taken
    done: Any         # bool[...], game over (every agent terminates)
    winner: Any       # int8[...]: 0 none, +1 agent 0, -1 agent 1
    last_action: Any  # int32[...], -1 before the first move
    rewards: Any      # float32[..., 2], the rewards the last step emitted


def zeros_state() -> GobbletState:
    """A fresh host-side (numpy) start state."""
    return GobbletState(
        board=np.zeros((NUM_LEVELS, NUM_CELLS), dtype=np.int8),
        current=np.int32(0),
        turn=np.int32(0),
        done=np.bool_(False),
        winner=np.int8(0),
        last_action=np.int32(-1),
        rewards=np.zeros(2, dtype=np.float32),
    )
