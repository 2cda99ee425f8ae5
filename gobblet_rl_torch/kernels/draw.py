"""Uniform draw of a legal action: the hand-written CUDA kernel and its
plain PyTorch version.

The kernel (``csrc/draw.cu``, built by :mod:`~gobblet_rl_torch.kernels.build`)
replaces no TPU kernel; its note says why it was added, what bounds it and
what its design does about that.  It turns a lane-major
batch (board ``int8[3, 9, B]``, mover ``int32[B]``) into one action per env,
uniform over that env's legal set, with the mask and the random bits in
registers.

Random bits: each call draws two int64 words from the caller's generator
on the batch's device (:func:`draw_key`), so the same generator state gives
the same actions and the generator advances as any draw advances it.
Env ``e`` takes one Philox4x32-10 block with key ``(key[0] low, key[0]
high)`` and counter ``(e, 0, key[1] low, key[1] high)``; its first two
words make the 64-bit draw ``u = y:x``.  Selection rule: with ``n`` legal
actions, ``r = floor(u * n / 2**64)`` and the action is the ``r``-th legal
one in index order (action 0 where none is legal).

:func:`random_legal_actions` launches the kernel for CUDA tensors and runs
:func:`random_legal_actions_plain` only for CPU tensors; it never falls
back.
"""

from __future__ import annotations

import torch

from gobblet_rl_torch.kernels import build
from gobblet_rl_torch.kernels.rollout import philox4x32_10
from gobblet_rl_torch.ops import batched_core as bc
from gobblet_rl_torch.utils import profiling

_MASK32 = 0xFFFFFFFF


def draw_key(generator: torch.Generator, device) -> torch.Tensor:
    """int64[2] drawn from ``generator`` on ``device``: the Philox key word
    and the counter's high words of one call."""
    return torch.empty(2, dtype=torch.int64, device=device).random_(generator=generator)


def random_legal_actions_plain(board: torch.Tensor, current: torch.Tensor,
                               key: torch.Tensor) -> torch.Tensor:
    """The kernel's function in batched tensor code, for the two int64
    words ``key``.  Same return contract as :func:`random_legal_actions`."""
    mask = bc.legal_mask_planes(board, current)                      # bool[54, B]
    env = torch.arange(board.shape[-1], dtype=torch.int64, device=board.device)
    k, ctr = key[0], key[1]
    x, y, _, _ = philox4x32_10(env, torch.zeros_like(env), ctr & _MASK32,
                               (ctr >> 32) & _MASK32, k & _MASK32, (k >> 32) & _MASK32)
    n = mask.sum(dim=0)                                              # int64[B], <= 54
    # floor((y * 2**32 + x) * n / 2**64) without leaving int64's range
    r = (y * n + ((x * n) >> 32)) >> 32
    hit = mask & (mask.cumsum(dim=0) == (r + 1)[None])
    return hit.to(torch.int8).argmax(dim=0).to(torch.int32)


def random_legal_actions(board: torch.Tensor, current: torch.Tensor,
                         generator: torch.Generator) -> torch.Tensor:
    """int32[B]: for each env of ``board`` (int8[3, 9, B], lane-major) with
    ``current`` (int32[B]) to move, an action drawn uniformly from its legal
    set; action 0 where none is legal.

    The key words come from ``generator`` on the batch's device
    (:func:`draw_key`).  CUDA tensors launch the kernel
    (``random_legal_actions.launches`` counts the launches); CPU tensors
    run :func:`random_legal_actions_plain`.  Any other device raises.
    While tracing is on, B is added to the counter ``draw.kernel_rows`` or
    ``draw.plain_rows``, by the path taken."""
    batch = build.check_batch(board, current)
    key = draw_key(generator, board.device)
    if board.device.type == "cpu":
        profiling.count("draw.plain_rows", batch)
        return random_legal_actions_plain(board, current, key)
    if board.device.type != "cuda":
        raise ValueError(f"no draw kernel for device {board.device}")
    out = torch.empty_like(current)
    if batch > 0:
        build.launch("draw", "draw", "ppppi", board.device, board, current, key, out, batch)
        random_legal_actions.launches += 1
    profiling.count("draw.kernel_rows", batch)
    return out


random_legal_actions.launches = 0
