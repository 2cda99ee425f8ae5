"""Observation planes and the action mask of one env (or a batch of them).

Port of ``gobblet_rl_tpu/core/observe.py``:

* the board is sign-flipped for agent 1, so one's own pieces are positive;
* channels 0-5 are one-hot planes of one's own pieces 1..6, channels 6-11
  of the opponent's, channel 12 the agent-index plane;
* the action mask is the legal mask for the agent to move and all zeros
  for the waiting agent.

:func:`observe_planes` and :func:`observe` take ``board int8[..., 3, 9]``
and follow its device; :func:`observe_np` is the host twin the AEC env
calls.
"""

from __future__ import annotations

import numpy as np
import torch

from gobblet_rl_torch.core import rules, rules_np
from gobblet_rl_torch.core import types as T

# the piece id of each of the 12 one-hot channels, on the own-perspective
# board, and the level each channel's piece lives on
_CH_PIECE_NP = np.concatenate([np.arange(1, 7), -np.arange(1, 7)]).astype(np.int8)
_CH_LEVEL_NP = np.concatenate([T.PIECE_LEVEL_NP, T.PIECE_LEVEL_NP])


def observe_planes(board: torch.Tensor, agent_idx: torch.Tensor) -> torch.Tensor:
    """int8[..., 3, 3, 13] observation planes of ``agent_idx``."""
    dev = board.device
    agent_idx = torch.as_tensor(agent_idx, device=dev)
    sign = torch.where(agent_idx == 0, 1, -1).to(torch.int8)
    own = board * sign[..., None, None]                             # int8[..., 3, 9]
    rows = own.index_select(-2, torch.from_numpy(_CH_LEVEL_NP.astype(np.int64)).to(dev))
    planes = (rows == torch.from_numpy(_CH_PIECE_NP).to(dev)[:, None]).to(torch.int8)
    agent_plane = agent_idx.to(torch.int8)[..., None, None].expand(*planes.shape[:-2], 1,
                                                                    T.NUM_CELLS)
    stacked = torch.cat([planes, agent_plane], dim=-2)              # [..., 13, 9]
    # cell -> (cell // 3, cell % 3), channels last
    return stacked.unflatten(-1, (3, 3)).movedim(-3, -1)


def observe(board: torch.Tensor, agent_idx: torch.Tensor, current: torch.Tensor):
    """(int8[..., 3, 3, 13] observation, int8[..., 54] action mask) for
    ``agent_idx``; the mask is zero unless ``agent_idx`` is to move."""
    dev = board.device
    agent_idx = torch.as_tensor(agent_idx, device=dev)
    current = torch.as_tensor(current, device=dev)
    mask = rules.legal_mask(board, current) & (agent_idx == current)[..., None]
    return observe_planes(board, agent_idx), mask.to(torch.int8)


def observe_np(board: np.ndarray, agent_idx: int, current: int):
    """Host twin of :func:`observe` for one env (the AEC env's)."""
    sign = 1 if agent_idx == 0 else -1
    own = (board * sign).astype(np.int8)
    rows = own[_CH_LEVEL_NP]
    planes = (rows == _CH_PIECE_NP[:, None]).astype(np.int8)
    agent_plane = np.full((1, T.NUM_CELLS), agent_idx, dtype=np.int8)
    stacked = np.concatenate([planes, agent_plane], axis=0)
    obs = np.transpose(stacked.reshape(T.OBS_CHANNELS, 3, 3), (1, 2, 0))
    if agent_idx == current:
        mask = rules_np.legal_mask(board, current).astype(np.int8)
    else:
        mask = np.zeros(T.NUM_ACTIONS, dtype=np.int8)
    return obs, mask
