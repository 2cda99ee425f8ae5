"""API-compatible ``Board`` facade over the vectorized NumPy rules.

Port of ``gobblet_rl_tpu/board.py``: the reference ``Board``'s public
surface (``squares``, a float 27-vector; ``squares_preview``; the action
encode/decode helpers; ``is_legal``, ``play_turn``, ``check_for_winner``,
``get_flatboard``, ``check_covered``, ``winning_combinations``), each rule
one call into :mod:`gobblet_rl_torch.core.rules_np`.
"""

from __future__ import annotations

import numpy as np

from gobblet_rl_torch.core import rules_np
from gobblet_rl_torch.core import types as T


class Board:
    def __init__(self, squares=None):
        # 27-vector: three stacked 3x3 levels (small/medium/large), cells in
        # column-major display order; float, as the reference's
        self.squares = np.zeros(27)
        self.squares_preview = np.zeros(27)
        self.calculate_winners()

    # -- views ----------------------------------------------------------
    def _grid(self) -> np.ndarray:
        """int8[3, 9] kernel view of the board."""
        return self.squares.reshape(T.NUM_LEVELS, T.NUM_CELLS).astype(np.int8)

    def setup(self):
        self.calculate_winners()

    # -- action encode / decode -----------------------------------------
    def get_action_from_pos_piece(self, pos, piece):
        if pos in range(9) and piece in range(1, 7):
            return 9 * (piece - 1) + pos
        return -1

    def get_action(self, pos, piece_size, agent_index):
        """First legal action placing either piece of ``piece_size`` at
        ``pos``; -1 if neither can move there."""
        mask = rules_np.legal_mask(self._grid(), agent_index)
        for piece in (piece_size * 2 - 1, piece_size * 2):
            action = pos + 9 * (piece - 1)
            if mask[action]:
                return action
        return -1

    def get_pos_from_action(self, action):
        return action % 9

    def get_piece_from_action(self, action):
        return (action // 9) + 1

    def get_piece_size_from_action(self, action):
        return (self.get_piece_from_action(action) + 1) // 2

    def get_index_from_action(self, action):
        pos = self.get_pos_from_action(action)
        piece_size = self.get_piece_size_from_action(action)
        return pos + 9 * (piece_size - 1)

    # -- rules, delegated to the vector rules ----------------------------
    def is_legal(self, action, agent_index=0):
        return bool(rules_np.is_legal(self._grid(), agent_index, int(action)))

    def play_turn(self, agent_index, action):
        grid = rules_np.apply_action(self._grid(), agent_index, int(action))
        self.squares = grid.flatten().astype(self.squares.dtype)

    def calculate_winners(self):
        """Win-line tuples in the reference's scan order."""
        self.winning_combinations = [tuple(line) for line in T.WIN_LINES_NP.tolist()]

    def get_flatboard(self):
        return rules_np.flatboard(self._grid()).astype(np.float64)

    def check_for_winner(self):
        return rules_np.line_winner(self._grid())

    def check_game_over(self):
        return self.check_for_winner() in (1, -1)

    def check_covered(self):
        return rules_np.covered(self._grid()).flatten().astype(np.float64)

    # -- debug helpers ---------------------------------------------------
    def print(self):
        print(self.get_flatboard().reshape(3, 3).transpose())

    def print_pieces(self):
        covered = self.check_covered()
        open_indices = [i for i in range(len(self.squares)) if self.squares[i] == 0]
        open_squares = [np.where(self.get_flatboard() == 0)[0]]
        occupied_squares = [i % 9 for i in range(len(self.squares)) if self.squares[i] != 0]
        movable_squares = [i % 9 for i in occupied_squares if covered[i] == 0]
        covered_squares = [i % 9 for i in np.where(covered == 1)[0]]
        print("open_indices: ", open_indices)
        print("open_squares: ", open_squares)
        print("squares with pieces: ", occupied_squares)
        print("squares with uncovered pieces: ", movable_squares)
        print("squares with covered pieces: ", covered_squares)

    def __str__(self):
        return str(self.squares.reshape(3, 3, 3))
