"""The play cells' traffic: positions reachable in random-admissible games.

Made from the seed with the reference's rules, on the host: games start
from the empty board, every ply plays a legal move drawn uniformly, and
each position before a move is kept (the player to move sees it).  A
won game stops; a game still running after ``max_plies`` is cut.  Games
are played ``games_at_once`` at a time; the positions are kept game by
game, each game's in the order they arose, until there are
``positions``.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import rules


def play_positions(seed: int, positions: int, max_plies: int, games_at_once: int = 64):
    """``(board int8[N, 3, 9], current int32[N])`` as numpy arrays."""
    rng = np.random.default_rng(seed)
    boards, currents, kept = [], [], 0
    while kept < positions:
        board = torch.zeros((games_at_once, 3, 9), dtype=torch.int8)
        current = torch.zeros(games_at_once, dtype=torch.int32)
        live = torch.ones(games_at_once, dtype=torch.bool)
        plies_b, plies_c, plies_live = [], [], []
        for _ in range(max_plies):
            if not live.any():
                break
            plies_b.append(board.clone())
            plies_c.append(current.clone())
            plies_live.append(live.clone())
            legal = rules.legal_mask(board, current).numpy()
            draws = rng.random(legal.shape)
            action = torch.from_numpy(np.where(legal, draws, -1.0).argmax(1))
            board = torch.where(live[:, None, None], rules.apply(board, current, action), board)
            live &= rules.winner(board) == 0
            current = 1 - current
        # game-major: [games, plies]
        b = torch.stack(plies_b, 1)
        c = torch.stack(plies_c, 1)
        keep = torch.stack(plies_live, 1)
        boards.append(b[keep])
        currents.append(c[keep])
        kept += int(keep.sum())
    board = torch.cat(boards)[:positions]
    current = torch.cat(currents)[:positions]
    return board.numpy(), current.numpy()
