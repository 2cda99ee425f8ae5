"""One-move win check: the hand-written CUDA kernel and its plain PyTorch
version.

The kernel (``csrc/wins.cu``, built by :mod:`~gobblet_rl_torch.kernels.build`)
replaces no TPU kernel; its note says why it was added, what bounds it and
what its design does about that.  It turns a lane-major batch (board
``int8[3, 9, B]``, mover ``int32[B]``) into ``bool[54, B]``: row ``a`` is
true where action ``a`` is legal and wins at once for the mover, under the
engine's last-line-wins fold, with every board read once and the 54 moves
tested in registers.

:func:`winning_actions` launches the kernel for CUDA tensors and runs
:func:`winning_actions_plain` only for CPU tensors; it never falls back.
"""

from __future__ import annotations

import torch

from gobblet_rl_torch.core.types import NUM_ACTIONS as A
from gobblet_rl_torch.kernels import build
from gobblet_rl_torch.ops import batched_core as bc
from gobblet_rl_torch.utils import profiling


def winning_actions_plain(board: torch.Tensor, player: torch.Tensor) -> torch.Tensor:
    """The kernel's function in batched tensor code: the 54 actions ride a
    folded 54·B lane axis of one engine call, lane ``a·B + b``.  Same
    return contract as :func:`winning_actions`."""
    B = player.shape[0]
    mask = bc.legal_mask_planes(board, player)
    actions = torch.arange(A, dtype=torch.int32, device=board.device).repeat_interleave(B)
    stepped = bc.apply_action_unchecked(board.repeat(1, 1, A), player.repeat(A), actions)
    win = bc.winner_planes(bc.flat_planes(stepped)).view(A, B)
    return mask & (win == bc.player_sign_planes(player)[None])


def winning_actions(board: torch.Tensor, player: torch.Tensor) -> torch.Tensor:
    """bool[54, B]: for each lane of ``board`` (int8[3, 9, B], lane-major,
    contiguous) with ``player`` (int32[B]) to move, the legal actions after
    which the mover has won.

    CUDA tensors launch the kernel (``winning_actions.launches`` counts the
    launches; B = 0 launches nothing); CPU tensors run
    :func:`winning_actions_plain`.  Any other device raises.  While tracing
    is on, B is added to the counter ``wins.kernel_rows`` or
    ``wins.plain_rows``, by the path taken."""
    batch = build.check_batch(board, player)
    if board.device.type == "cpu":
        profiling.count("wins.plain_rows", batch)
        return winning_actions_plain(board, player)
    if board.device.type != "cuda":
        raise ValueError(f"no win-check kernel for device {board.device}")
    out = torch.empty((A, batch), dtype=torch.bool, device=board.device)
    if batch > 0:
        build.launch("wins", "win-check", "pppi", board.device, board, player, out, batch)
        winning_actions.launches += 1
    profiling.count("wins.kernel_rows", batch)
    return out


winning_actions.launches = 0
