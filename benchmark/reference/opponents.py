"""The moves an opponent may make, as sets, for the plain reference.

A checked reply is judged by membership: the program draws its ties from
its own generator, so the reference asks only whether the move it played
is one the opponent's rule allows.

* ``random``: any legal move.
* ``greedy`` (depth 1 or 2), in priority order: the lowest-numbered move
  that wins at once; else (depth 2) any "safe" move, one that ends
  nothing and after which no reply of the other side wins at once; else
  any legal move that does not lose at once; else any legal move.
"""

from __future__ import annotations

import torch

from benchmark.reference import rules


def _opp_can_win(boards1: torch.Tensor, mover_sign: torch.Tensor) -> torch.Tensor:
    """bool[M]: whether the side that did NOT move (``-mover_sign``) has a
    legal reply on ``boards1`` [M, 3, 9] that wins at once for it."""
    replier = torch.where(mover_sign > 0, 1, 0).to(torch.int32)   # player index of -mover
    legal = rules.legal_mask(boards1, replier)
    after = rules.apply_all(boards1, replier)                      # [M, 54, 3, 9]
    w2 = rules.winner(after.flatten(0, 1)).view(-1, rules.NUM_ACTIONS)
    return (legal & (w2 == -mover_sign[:, None])).any(1)


def allowed(kind: str, board: torch.Tensor, current: torch.Tensor, depth: int = 2,
            chunk: int = 2048) -> torch.Tensor:
    """bool[N, 54]: the moves the opponent ``kind`` may play on ``board``
    [N, 3, 9] with ``current`` [N] to move."""
    if kind == "random":
        return rules.legal_mask(board, current)
    if kind != "greedy":
        raise ValueError(f"no reference for the opponent {kind!r}")
    return torch.cat([_greedy_allowed(board[i:i + chunk], current[i:i + chunk], depth)
                      for i in range(0, board.shape[0], chunk)]) if board.shape[0] else \
        torch.zeros((0, rules.NUM_ACTIONS), dtype=torch.bool, device=board.device)


def _greedy_allowed(board, current, depth):
    n = board.shape[0]
    s = rules.sign(current)
    legal = rules.legal_mask(board, current)
    boards1 = rules.apply_all(board, current)                      # [N, 54, 3, 9]
    w1 = rules.winner(boards1.flatten(0, 1)).view(n, rules.NUM_ACTIONS)
    win = legal & (w1 == s[:, None])
    lose = legal & (w1 == -s[:, None])
    out = legal.clone()
    nonlosing = legal & ~lose
    out = torch.where(nonlosing.any(1, keepdim=True), nonlosing, out)
    if depth >= 2:
        quiet = legal & (w1 == 0)
        threat = _opp_can_win(boards1.flatten(0, 1),
                              s.repeat_interleave(rules.NUM_ACTIONS)).view(n, rules.NUM_ACTIONS)
        safe = quiet & ~threat
        out = torch.where(safe.any(1, keepdim=True), safe, out)
    lowest = torch.zeros_like(win)
    first = win.to(torch.uint8).argmax(1)
    lowest[torch.arange(n, device=board.device), first] = True
    return torch.where(win.any(1, keepdim=True), lowest & win, out)
