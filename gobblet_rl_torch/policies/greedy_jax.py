"""Batched depth-1/2 greedy lookahead, lane-major, as torch tensor code.

Port of ``gobblet_rl_tpu/policies/greedy_jax.py`` (the module keeps its
name).  The 54 candidate moves of every env are laid out as one lane-major
batch ``[3, 9, 54·B]``, lane ``a·B + b`` holding action ``a`` on board
``b``, so one :func:`~gobblet_rl_torch.ops.batched_core.step_planes` call
plays every candidate and each of the 54 opponent replies is one more pass
over ``54·B`` lanes.

Decision rule, in priority order (later picks overwrite earlier ones):

1. an immediately winning move, the lowest action index;
2. otherwise a "safe" move — no immediate result, and no opponent reply
   wins — drawn uniformly (depth 2 only);
3. otherwise a random legal move that does not lose on the spot;
4. otherwise a random legal move (action 0 when none is legal).

The uniform draws are one Gumbel argmax over a ``[54, B]`` field, drawn
from ``generator`` or passed in as ``gumbel`` (the parity tests rebuild
JAX's field from its key, which makes the two bit-identical).
"""

from __future__ import annotations

import torch

from gobblet_rl_torch.ops import batched_core as bc


def _apply_all_actions(board: torch.Tensor, current: torch.Tensor) -> torch.Tensor:
    """int8[3, 9, 54·B]: every action applied to every board, lane
    ``a·B + b``; an illegal action leaves its board unchanged."""
    B = board.shape[-1]
    n = 54 * B
    actions = torch.arange(54, dtype=torch.int32, device=board.device).repeat_interleave(B)
    state = bc.PlanesState(
        board=board.repeat(1, 1, 54),
        current=current.repeat(54),
        turn=torch.zeros(n, dtype=torch.int32, device=board.device),
        done=torch.zeros(n, dtype=torch.bool, device=board.device),
        winner=torch.zeros(n, dtype=torch.int8, device=board.device),
        last_action=actions,
        rewards=torch.zeros((2, n), dtype=torch.float32, device=board.device),
    )
    return bc.step_planes(state, actions).board


def reply_winner(boards: torch.Tensor, sign: torch.Tensor, action: int) -> torch.Tensor:
    """int8[N]: ``step_planes(...).winner`` of the constant ``action`` played
    by the side of ``sign`` (int8[N], +1 / -1) on live games ``boards``
    [3, 9, N] — the winner of the new board where the move is legal, 0
    where it is not.

    The action is a host integer, so its piece, level and cell are
    constants: legality reads one cell and one level, and placement writes
    one level, instead of the whole board."""
    piece = action // 9 + 1
    level = (piece + 1) // 2 - 1
    cell = action % 9
    size = level + 1
    signed = sign * piece                                  # int8[N]
    row = boards[level]                                    # [9, N]
    pres = row == signed[None]
    if level == 0:
        frozen = (pres & ((boards[1] != 0) | (boards[2] != 0))).any(dim=0)
    elif level == 1:
        frozen = (pres & (boards[2] != 0)).any(dim=0)
    else:
        frozen = None                                      # nothing covers a large piece
    top = bc.flat_planes(boards[:, cell:cell + 1])[0]      # topmost piece at the target
    legal = (top == 0) | (size > (top.abs() + 1) >> 1)
    if frozen is not None:
        legal &= ~frozen
    new_row = torch.where(pres, 0, row)
    new_row[cell] = signed
    levels = [boards[0], boards[1], boards[2]]
    levels[level] = new_row
    flat = torch.where(levels[2] != 0, levels[2], torch.where(levels[1] != 0, levels[1], levels[0]))
    return torch.where(legal, bc.winner_planes(flat), 0)


def greedy_actions(generator: torch.Generator | None, board: torch.Tensor,
                   current: torch.Tensor, depth: int = 2,
                   gumbel: torch.Tensor | None = None) -> torch.Tensor:
    """int32[B] greedy moves for the player to move in each env of
    ``board`` int8[3, 9, B], ``current`` int32[B].

    ``gumbel`` is an optional float32 [54, B] field; without it the noise
    is drawn from ``generator``."""
    B = board.shape[-1]
    sign = bc.player_sign_planes(current)                  # my winner value, [B]
    mask = bc.legal_mask_planes(board, current)            # [54, B]

    boards1 = _apply_all_actions(board, current)           # [3, 9, 54·B]
    w1 = bc.winner_planes(bc.flat_planes(boards1)).view(54, B)
    i_win = mask & (w1 == sign[None])                      # immediate wins
    i_lose = mask & (w1 == -sign[None])                    # immediate losses (uncovering)

    if depth >= 2:
        opp_sign = (-sign).repeat(54)                      # the replying side, lane a·B + b
        opp_can_win = torch.zeros((54, B), dtype=torch.bool, device=board.device)
        for r in range(54):
            opp_can_win |= (reply_winner(boards1, opp_sign, r) == opp_sign).view(54, B)
        safe = mask & (w1 == 0) & ~opp_can_win
    del boards1

    if gumbel is None:
        if generator is None:
            raise ValueError("greedy_actions needs a generator or a gumbel field")
        gumbel = bc.gumbel_field(generator, (54, B), board.device)

    def pick(m, fallback):
        best = torch.where(m, gumbel, -torch.inf).argmax(dim=0)
        return torch.where(m.any(dim=0), best, fallback)

    # priority 4 -> 1: later picks overwrite
    action = pick(mask, torch.zeros(B, dtype=torch.int64, device=board.device))
    action = pick(mask & ~i_lose, action)
    if depth >= 2:
        action = pick(safe, action)
    # immediate win: the lowest index (argmax takes the first maximum)
    win_idx = i_win.to(torch.uint8).argmax(dim=0)
    action = torch.where(i_win.any(dim=0), win_idx, action)
    return action.to(torch.int32)
