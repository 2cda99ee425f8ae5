"""Functional transitions of one env, or of a batch with a leading axis.

Port of ``gobblet_rl_tpu/core/env.py``, with its two step semantics:

* :func:`step_raw`, the reference ``raw_env.step``: an illegal action
  leaves the board as it is, but the turn passes to the other agent;
* :func:`step_strict`, the wrapped ``env()`` under
  ``TerminateIllegalWrapper(illegal_reward=-1)``: an illegal action ends
  the game, with reward -1 for the mover and 0 for the other, and keeps
  the board, the player to move and the turn (batched training's
  semantics).

Under both, a finished game is frozen and emits zero rewards.  A state is a
:class:`~gobblet_rl_torch.core.types.GobbletState` of tensors; every field
has the batch shape ``[...]`` in front (``board [..., 3, 9]``, ``rewards
[..., 2]``), so ``batched_step_raw`` and ``batched_step_strict`` are the
same functions.  ``reset(device=None)`` means the CUDA card, or raise;
steps follow the state's device.
"""

from __future__ import annotations

import torch

from gobblet_rl_torch.core import rules
from gobblet_rl_torch.core.types import GobbletState
from gobblet_rl_torch.device import resolve_device


def _start(shape: tuple, device) -> GobbletState:
    dev = resolve_device(device)
    return GobbletState(
        board=torch.zeros(shape + (3, 9), dtype=torch.int8, device=dev),
        current=torch.zeros(shape, dtype=torch.int32, device=dev),
        turn=torch.zeros(shape, dtype=torch.int32, device=dev),
        done=torch.zeros(shape, dtype=torch.bool, device=dev),
        winner=torch.zeros(shape, dtype=torch.int8, device=dev),
        last_action=torch.full(shape, -1, dtype=torch.int32, device=dev),
        rewards=torch.zeros(shape + (2,), dtype=torch.float32, device=dev),
    )


def reset(device=None) -> GobbletState:
    """A fresh start state."""
    return _start((), device)


def batched_reset(batch: int, device=None) -> GobbletState:
    """``batch`` fresh start states, batch-first."""
    return _start((batch,), device)


def _advance(state: GobbletState, action: torch.Tensor, legal: torch.Tensor) -> GobbletState:
    board = rules.apply_action(state.board, state.current, action, legal=legal)
    winner = rules.line_winner(board)
    w = winner.to(torch.float32)
    # winner +1: agent 0 gets +1 and agent 1 -1; winner -1 mirrored
    return GobbletState(
        board=board,
        current=1 - state.current,
        turn=state.turn + 1,
        done=winner != 0,
        winner=winner,
        last_action=action.to(torch.int32).expand_as(state.current),
        rewards=torch.stack([w, -w], dim=-1),
    )


def _frozen(state: GobbletState) -> GobbletState:
    """The post-terminal no-op: the state unchanged, zero rewards."""
    return state._replace(rewards=torch.zeros_like(state.rewards))


def _select(pred: torch.Tensor, a: GobbletState, b: GobbletState) -> GobbletState:
    """Field by field ``where(pred, a, b)``, ``pred`` of the batch shape."""
    return GobbletState(*(torch.where(pred.reshape(pred.shape + (1,) * (x.dim() - pred.dim())),
                                      x, y) for x, y in zip(a, b)))


def step_raw(state: GobbletState, action) -> GobbletState:
    """``raw_env.step`` semantics; stepping a finished game is a frozen
    no-op."""
    action = torch.as_tensor(action, device=state.board.device)
    legal = rules.is_legal(state.board, state.current, action)
    return _select(state.done, _frozen(state), _advance(state, action, legal))


def step_strict(state: GobbletState, action) -> GobbletState:
    """Terminate-illegal semantics (batched training's)."""
    action = torch.as_tensor(action, device=state.board.device)
    legal = rules.is_legal(state.board, state.current, action)
    stepped = _advance(state, action, legal)
    mover_onehot = (torch.arange(2, device=action.device)
                    == state.current[..., None]).to(torch.float32)
    illegal_term = state._replace(
        done=torch.ones_like(state.done),
        rewards=-mover_onehot,
        last_action=action.to(torch.int32).expand_as(state.current),
    )
    live = _select(legal, stepped, illegal_term)
    return _select(state.done, _frozen(state), live)


batched_step_raw = step_raw
batched_step_strict = step_strict
