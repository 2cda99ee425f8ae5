"""Lane-major (batch-last) batched Gobblet engine as PyTorch tensor code.

Port of ``gobblet_rl_tpu/ops/batched_core.py``.  Every array is
``[small..., B]`` with the environment batch last, so on the card one env
maps to one thread of an elementwise kernel and reads coalesce across the
batch.  Every rule is ``where``-algebra over the whole batch:

* flatboard is a 3-way select over levels (piece ids grow with level);
* "is my piece covered" is ``any(presence & covered)`` (a piece occurs at
  most once);
* placement is a one-hot masked select;
* the win scan folds the 8 lines in reference order, so the LAST matching
  line decides.

Dtypes follow the JAX module: board int8, current/turn/last_action int32,
done bool, winner int8, rewards float32.  Randomness comes only from an
explicit ``torch.Generator`` (or a pre-drawn field, for the parity tests).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gobblet_rl_torch.core import types as T
from gobblet_rl_torch.device import resolve_device

WIN_LINES = [tuple(int(c) for c in line) for line in T.WIN_LINES_NP]


class PlanesState(NamedTuple):
    """Batched env state, batch-last."""

    board: torch.Tensor        # int8[3, 9, B]
    current: torch.Tensor      # int32[B]
    turn: torch.Tensor         # int32[B]
    done: torch.Tensor         # bool[B]
    winner: torch.Tensor       # int8[B]
    last_action: torch.Tensor  # int32[B]
    rewards: torch.Tensor      # float32[2, B]


def reset_planes(batch: int, device=None) -> PlanesState:
    dev = resolve_device(device)
    return PlanesState(
        board=torch.zeros((3, 9, batch), dtype=torch.int8, device=dev),
        current=torch.zeros(batch, dtype=torch.int32, device=dev),
        turn=torch.zeros(batch, dtype=torch.int32, device=dev),
        done=torch.zeros(batch, dtype=torch.bool, device=dev),
        winner=torch.zeros(batch, dtype=torch.int8, device=dev),
        last_action=torch.full((batch,), -1, dtype=torch.int32, device=dev),
        rewards=torch.zeros((2, batch), dtype=torch.float32, device=dev),
    )


def covered_planes(board: torch.Tensor) -> torch.Tensor:
    """bool[3, 9, B] — elementwise covered mask."""
    occ = board != 0
    return torch.stack([occ[0] & (occ[1] | occ[2]), occ[1] & occ[2],
                        torch.zeros_like(occ[2])])


def flat_planes(board: torch.Tensor) -> torch.Tensor:
    """int8[9, B] — topmost signed piece per cell (3-way level select)."""
    return torch.where(board[2] != 0, board[2],
                       torch.where(board[1] != 0, board[1], board[0]))


def player_sign_planes(current: torch.Tensor) -> torch.Tensor:
    """int8[B]: +1 for player 0, -1 for player 1."""
    return torch.where(current == 0, 1, -1).to(torch.int8)


def legal_mask_planes(board: torch.Tensor, current: torch.Tensor) -> torch.Tensor:
    """bool[54, B] legal mask, fully elementwise.

    Row ``a`` is action ``a``: piece ``a // 9 + 1`` onto cell ``a % 9``.  The
    static per-action tables of the JAX module become ``repeat`` (row a =
    cell a % 9) and ``repeat_interleave`` (row a = piece a // 9 + 1)."""
    dev = board.device
    own = board * player_sign_planes(current)                 # int8[3,9,B]
    cov = covered_planes(board)

    # piece p (1..6) lives on level (p - 1) // 2: rows 0,0,1,1,2,2
    rows = own.repeat_interleave(2, dim=0)                    # [6,9,B]
    ids = torch.arange(1, 7, dtype=torch.int8, device=dev).view(6, 1, 1)
    frozen = ((rows == ids) & cov.repeat_interleave(2, dim=0)).any(dim=1)

    flat = flat_planes(board)                                 # [9,B]
    top_size = ((flat.abs() + 1) >> 1).to(torch.int8)
    sizes = torch.arange(1, 4, dtype=torch.int8, device=dev)
    a_size = sizes.repeat_interleave(18).view(54, 1)          # size of a's piece
    target_ok = (flat.repeat(6, 1) == 0) | (a_size > top_size.repeat(6, 1))
    return target_ok & ~frozen.repeat_interleave(9, dim=0)


def winner_planes(flat: torch.Tensor) -> torch.Tensor:
    """int8[B] with the reference's last-line-wins fold."""
    w = torch.zeros(flat.shape[-1], dtype=torch.int8, device=flat.device)
    for c0, c1, c2 in WIN_LINES:
        pos = (flat[c0] > 0) & (flat[c1] > 0) & (flat[c2] > 0)
        neg = (flat[c0] < 0) & (flat[c1] < 0) & (flat[c2] < 0)
        lw = pos.to(torch.int8) - neg.to(torch.int8)
        w = torch.where(lw != 0, lw, w)
    return w


def _place(board, sign, actions):
    """(signed moving piece, lifted board, place mask) for ``actions``."""
    dev = board.device
    piece = actions // 9 + 1
    level = ((piece + 1) >> 1) - 1
    signed = piece.to(torch.int8) * sign
    pres = board == signed[None, None]
    cell_oh = torch.arange(9, device=dev)[:, None] == (actions % 9)[None]
    lvl_oh = torch.arange(3, device=dev)[:, None] == level[None]
    place = lvl_oh[:, None, :] & cell_oh[None, :, :]
    return signed, pres, cell_oh, place


def step_planes(state: PlanesState, actions: torch.Tensor) -> PlanesState:
    """One batched ply with terminate-illegal semantics; finished games stay
    frozen."""
    board, current = state.board, state.current
    actions = actions.to(torch.int32)
    sign = player_sign_planes(current)
    size = (((actions // 9 + 1) + 1) >> 1).to(torch.int32)
    signed, pres, cell_oh, place = _place(board, sign, actions)

    # scalar legality, elementwise: presence of the moving piece anywhere on
    # the board (ids are level-unique) and its covered status
    cov = covered_planes(board)
    frozen_mv = (pres & cov).flatten(0, 1).any(dim=0)          # [B]
    flat_a = torch.where(cell_oh, flat_planes(board), 0).sum(dim=0, dtype=torch.int32)
    top_sz = (flat_a.abs() + 1) >> 1
    legal = ((flat_a == 0) | (size > top_sz)) & ~frozen_mv

    lifted = torch.where(pres, 0, board)
    played = torch.where(place, signed[None, None], lifted)
    new_board = torch.where(legal[None, None], played, board)

    winner = winner_planes(flat_planes(new_board))
    won = winner != 0
    wf = winner.to(torch.float32)
    win_rewards = torch.stack([wf, -wf])                       # [2,B]

    mover0 = current == 0
    ill_rewards = torch.stack(
        [torch.where(mover0, -1.0, 0.0), torch.where(mover0, 0.0, -1.0)]
    )

    # compose: legal step / illegal termination / frozen
    live = ~state.done
    adv = live & legal
    zero8 = torch.zeros((), dtype=torch.int8, device=board.device)
    return PlanesState(
        board=torch.where(adv[None, None], new_board, board),
        current=torch.where(adv, 1 - current, current),
        turn=torch.where(adv, state.turn + 1, state.turn),
        done=state.done | (live & (~legal | won)),
        winner=torch.where(adv, winner, torch.where(live, zero8, state.winner)),
        last_action=torch.where(live, actions, state.last_action),
        rewards=torch.where(
            adv[None], win_rewards,
            torch.where(live[None], ill_rewards * (~legal)[None], 0.0),
        ),
    )


def autoreset_planes(state: PlanesState) -> PlanesState:
    """Restart finished games (emitted rewards stay with the caller)."""
    d = state.done
    return PlanesState(
        board=torch.where(d[None, None], 0, state.board),
        current=torch.where(d, 0, state.current),
        turn=torch.where(d, 0, state.turn),
        done=torch.zeros_like(d),
        winner=torch.where(d, 0, state.winner),
        last_action=torch.where(d, -1, state.last_action),
        rewards=state.rewards,
    )


def observe_planes_lm(board: torch.Tensor, agent: torch.Tensor) -> torch.Tensor:
    """int8[13, 9, B] observation planes, lane-major.

    Flattened index order is (channel, cell), a fixed permutation of the
    reference's (row, col, channel); :func:`to_reference_obs` restores the
    reference layout."""
    dev = board.device
    own = board * player_sign_planes(agent)
    # channel k < 6 is own piece k + 1, channel k >= 6 the opponent's
    # piece k - 5; both on level (piece - 1) // 2
    rows = own.repeat_interleave(2, dim=0).repeat(2, 1, 1)    # [12,9,B]
    ids = torch.arange(1, 7, dtype=torch.int8, device=dev)
    ch_piece = torch.cat([ids, -ids]).view(12, 1, 1)
    planes = (rows == ch_piece).to(torch.int8)
    agent_plane = agent.to(torch.int8)[None, None].expand(1, 9, planes.shape[-1])
    return torch.cat([planes, agent_plane], dim=0)


def to_reference_obs(planes: torch.Tensor) -> torch.Tensor:
    """[13, 9, B] lane-major planes -> [B, 3, 3, 13] reference layout."""
    b = planes.shape[-1]
    return planes.permute(2, 1, 0).reshape(b, 3, 3, 13)


def features_lm(board: torch.Tensor, agent: torch.Tensor) -> torch.Tensor:
    """int8[117, B] flattened observation for lane-major nets."""
    return observe_planes_lm(board, agent).reshape(117, -1)


def gumbel_field(generator: torch.Generator, shape, device) -> torch.Tensor:
    """float32 standard Gumbel noise drawn from ``generator``."""
    u = torch.rand(shape, generator=generator, device=device)
    u.clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_random_lm(generator: torch.Generator | None, mask: torch.Tensor,
                     gumbel: torch.Tensor | None = None) -> torch.Tensor:
    """int32[B] uniform over the legal set of ``mask`` [54, B] by Gumbel
    argmax over the action axis (ties go to the lowest index).

    ``gumbel`` is an optional pre-drawn float32 [54, B] field; without it
    the noise comes from ``generator``."""
    if gumbel is None:
        if generator is None:
            raise ValueError("sample_random_lm needs a generator or a gumbel field")
        gumbel = gumbel_field(generator, mask.shape, mask.device)
    return torch.where(mask, gumbel, -torch.inf).argmax(dim=0).to(torch.int32)


def apply_action_unchecked(board: torch.Tensor, current: torch.Tensor,
                           actions: torch.Tensor) -> torch.Tensor:
    """Placement only — the caller guarantees ``actions`` are legal and the
    games live; skips the legality re-derivation of :func:`step_planes`."""
    signed, pres, _, place = _place(board, player_sign_planes(current),
                                    actions.to(torch.int32))
    return torch.where(place, signed[None, None], torch.where(pres, 0, board))


def step_trusted(state: PlanesState, actions: torch.Tensor) -> PlanesState:
    """:func:`step_planes` minus the legality re-derivation, for actions that
    are legal by construction (sampled or argmaxed from
    :func:`legal_mask_planes`).  A live position always has a legal move, so
    the outcome is bit-identical to :func:`step_planes` for such actions."""
    live = ~state.done
    actions = actions.to(torch.int32)
    new_board = apply_action_unchecked(state.board, state.current, actions)
    winner = winner_planes(flat_planes(new_board))
    wf = winner.to(torch.float32)
    return PlanesState(
        board=torch.where(live[None, None], new_board, state.board),
        current=torch.where(live, 1 - state.current, state.current),
        turn=torch.where(live, state.turn + 1, state.turn),
        done=state.done | (live & (winner != 0)),
        winner=torch.where(live, winner, state.winner),
        last_action=torch.where(live, actions, state.last_action),
        rewards=torch.where(live[None], torch.stack([wf, -wf]), 0.0),
    )


# ---------------------------------------------------------------------------
# Rollout
# ---------------------------------------------------------------------------
def rollout_random(state: PlanesState, generator: torch.Generator | None,
                   num_steps: int, gumbel: torch.Tensor | None = None):
    """Random-admissible self-play rollout with in-loop auto-reset; returns
    ``(state, stats)`` with int64 totals ``episodes``, ``wins_p1`` and
    ``wins_p2``.  ``generator`` advances in place.

    ``gumbel`` is an optional pre-drawn float32 ``[num_steps, 54, B]``
    field.  Every state entering a ply is live and every action is drawn
    from the legal mask, so the unchecked placement is exact."""
    board, current, turn = state.board, state.current, state.turn
    dev = board.device
    eps = torch.zeros((), dtype=torch.int64, device=dev)
    w1 = torch.zeros((), dtype=torch.int64, device=dev)
    w2 = torch.zeros((), dtype=torch.int64, device=dev)
    actions = state.last_action
    for t in range(num_steps):
        mask = legal_mask_planes(board, current)
        actions = sample_random_lm(generator, mask,
                                   None if gumbel is None else gumbel[t])
        board = apply_action_unchecked(board, current, actions)
        winner = winner_planes(flat_planes(board))
        done = winner != 0
        eps += done.sum()
        w1 += (winner == 1).sum()
        w2 += (winner == -1).sum()
        board = torch.where(done[None, None], 0, board)
        current = torch.where(done, 0, 1 - current)
        turn = torch.where(done, 0, turn + 1)
    state = state._replace(board=board, current=current, turn=turn,
                           last_action=actions)
    return state, {"episodes": eps, "wins_p1": w1, "wins_p2": w2}
