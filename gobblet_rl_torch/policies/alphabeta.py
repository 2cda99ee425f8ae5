"""Alpha-beta expert policy over the native C++ engine.

Port of ``gobblet_rl_tpu/policies/alphabeta.py``: iterative-deepening
negamax with a Zobrist transposition table (``csrc/gobblet.cpp``, built
by :mod:`gobblet_rl_torch.native.engine`) behind the
``compute_action(obs, mask)`` surface of
:class:`~gobblet_rl_torch.policies.greedy.GreedyGobbletPolicy`, so it plugs
into ``GameSession``, the AEC examples and the framework adapters.
"""

from __future__ import annotations

import numpy as np

from gobblet_rl_torch.native import engine
from gobblet_rl_torch.policies.greedy import board_from_observation


class AlphaBetaGobbletPolicy:
    """Host expert: rebuilds the board from the (3, 3, 13) observation and
    asks the native engine for the alpha-beta move."""

    def __init__(self, depth: int = 6, seed: int = 0):
        self.lib = engine.load()
        self.depth = depth
        self._salt = ((seed << 1) | 1) % 2**64

    def compute_action(self, obs, mask) -> int:
        board, agent = board_from_observation(np.asarray(obs))
        flat = np.ascontiguousarray(board.reshape(27), np.int8)
        # a fresh salt every move (an LCG mod 2^64) varies the ties between
        # games without changing the playing strength
        self._salt = (self._salt * 6364136223846793005 + 1442695040888963407) % 2**64
        action = int(self.lib.gob_alphabeta_action(flat, agent, self.depth, self._salt))
        if action < 0 or not np.asarray(mask)[action]:
            legal = np.flatnonzero(np.asarray(mask))
            return int(legal[0]) if legal.size else 0
        return action

    # the surface of GreedyGobbletPolicy's adapters
    def compute_action_tianshou(self, obs, mask):
        return self.compute_action(obs, mask)
