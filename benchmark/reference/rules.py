"""Plain Gobblet rules over a batch of boards, batch-first, in torch.

The benchmark's own copy of the game, written from its rules and kept
apart from the program under test: it imports nothing of the program.

* A board is ``int8[N, 3, 9]``: ``board[n, level, cell]`` holds the signed
  piece id at ``cell`` (0-8) on stacking ``level`` (0 small, 1 medium,
  2 large).  Ids 1..6 belong to player 0 and -1..-6 to player 1 (1-2 small,
  3-4 medium, 5-6 large); each id appears at most once.
* Action ``a`` (0-53) moves piece ``a // 9 + 1`` of the player to move
  onto cell ``a % 9``, from its reserve or from wherever it stands.
* A move is legal where the target cell is empty or topped by a smaller
  piece, and the moving piece is not covered by a larger one.
* The winner is read from the topmost pieces over the eight lines in a
  fixed order; the last line that one side fills decides (a lifted piece
  can complete a line for both sides at once).
"""

from __future__ import annotations

import torch

NUM_ACTIONS = 54
WIN_LINES = ((0, 1, 2), (3, 4, 5), (6, 7, 8), (0, 3, 6), (1, 4, 7), (2, 5, 8),
             (0, 4, 8), (2, 4, 6))
_A = torch.arange(NUM_ACTIONS)
A_CELL = _A % 9
A_PIECE = _A // 9 + 1
A_SIZE = (A_PIECE + 1) // 2


def sign(current: torch.Tensor) -> torch.Tensor:
    """int8[N]: +1 for player 0, -1 for player 1."""
    return torch.where(current == 0, 1, -1).to(torch.int8)


def top(board: torch.Tensor) -> torch.Tensor:
    """int8[N, 9]: the topmost signed piece of each cell (0 if empty)."""
    return torch.where(board[:, 2] != 0, board[:, 2],
                       torch.where(board[:, 1] != 0, board[:, 1], board[:, 0]))


def winner(board: torch.Tensor) -> torch.Tensor:
    """int8[N]: 0, +1 (player 0) or -1 (player 1); the last full line wins."""
    flat = top(board)
    w = torch.zeros(board.shape[0], dtype=torch.int8, device=board.device)
    for line in WIN_LINES:
        cells = flat[:, list(line)]
        lw = (cells > 0).all(1).to(torch.int8) - (cells < 0).all(1).to(torch.int8)
        w = torch.where(lw != 0, lw, w)
    return w


def legal_mask(board: torch.Tensor, current: torch.Tensor) -> torch.Tensor:
    """bool[N, 54]: the legal moves of the player to move."""
    dev = board.device
    own = board * sign(current)[:, None, None]
    occ = board != 0
    covered = torch.stack([occ[:, 0] & (occ[:, 1] | occ[:, 2]), occ[:, 1] & occ[:, 2],
                           torch.zeros_like(occ[:, 2])], dim=1)
    frozen = torch.stack([((own[:, (p - 1) // 2] == p) & covered[:, (p - 1) // 2]).any(1)
                          for p in range(1, 7)], dim=1)                  # [N, 6]
    flat = top(board)
    top_size = (flat.abs().to(torch.int32) + 1) // 2
    cell, piece, size = A_CELL.to(dev), A_PIECE.to(dev), A_SIZE.to(dev)
    target_ok = (flat[:, cell] == 0) | (size[None] > top_size[:, cell])
    return target_ok & ~frozen[:, piece - 1]


def apply(board: torch.Tensor, current: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """int8[N, 3, 9]: ``action`` [N] played by the player to move.  The
    caller checks legality first; this only lifts and places the piece."""
    n = board.shape[0]
    action = action.to(torch.int64)
    piece = action // 9 + 1
    level = (piece + 1) // 2 - 1
    signed = (piece * sign(current).to(torch.int64)).to(torch.int8)
    out = torch.where(board == signed[:, None, None], torch.zeros_like(board), board)
    out[torch.arange(n, device=board.device), level, action % 9] = signed
    return out


def apply_all(board: torch.Tensor, current: torch.Tensor) -> torch.Tensor:
    """int8[N, 54, 3, 9]: every action played on every board (the entries
    of illegal actions are meaningless; callers mask them)."""
    n = board.shape[0]
    boards = board.repeat_interleave(NUM_ACTIONS, dim=0)
    cur = current.repeat_interleave(NUM_ACTIONS)
    acts = torch.arange(NUM_ACTIONS, device=board.device).repeat(n)
    return apply(boards, cur, acts).view(n, NUM_ACTIONS, 3, 9)


def pieces_on_board(board: torch.Tensor) -> torch.Tensor:
    """int64[N]: how many pieces stand on each board."""
    return (board != 0).flatten(1).sum(1)


def features(board: torch.Tensor, agent: torch.Tensor) -> torch.Tensor:
    """float32[N, 117]: the Q-net's input for ``agent``, the (3, 3, 13)
    observation's planes in (channel, cell) order.  Channels 0-5 are the
    agent's own pieces 1..6, channels 6-11 the opponent's, and channel 12
    is the agent's index on every cell; the board is read from the agent's
    side (its own pieces positive)."""
    own = board * sign(agent)[:, None, None]
    planes = []
    for s in (1, -1):
        for p in range(1, 7):
            planes.append(own[:, (p - 1) // 2] == s * p)
    planes.append(agent[:, None].expand(-1, 9) == 1)
    return torch.stack(planes, dim=1).to(torch.float32).reshape(board.shape[0], 117)


def observation(board: torch.Tensor, agent: torch.Tensor) -> torch.Tensor:
    """int8[N, 3, 3, 13]: the observation a player sees, cell ``r * 3 + c``
    at row ``r`` and column ``c``, channels last."""
    planes = features(board, agent).view(-1, 13, 3, 3)
    return planes.permute(0, 2, 3, 1).to(torch.int8).contiguous()
