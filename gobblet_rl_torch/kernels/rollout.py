"""Fused random-admissible rollout: the hand-written CUDA kernel and its
plain PyTorch version.

Port of ``gobblet_rl_tpu/ops/pallas_rollout.py``.  The kernel
(``csrc/rollout.cu``) runs ``num_steps`` plies of random self-play per env
with the board in registers; its note says what bounds it and why.

Random bits: Philox4x32-10 keyed on ``(seed, env)`` with counter
``(ply, chunk, 0, 0)``, 11 blocks a ply.  Read as one 128-bit little-endian
number ``w:z:y:x``, block ``c`` holds five 24-bit draws at bit offsets 0,
24, 48, 72 and 96: draw ``j`` is action ``5c + j`` (bits 120-127 and the
fifth draw of block 10 are unused).  :func:`philox_field` gives each draw as
the word ``draw << 8``, so the plain version fed with it reproduces the
kernel bit for bit.  Selection rule (as the TPU kernel): for each legal
action take ``bits >> 8``, give illegal actions -1, take the max, and break
ties toward the lowest index.

:func:`rollout_random_fused` launches the kernel for CUDA tensors and runs
the plain version only for CPU tensors; it never falls back.
"""

from __future__ import annotations

import torch

from gobblet_rl_torch.kernels import build
from gobblet_rl_torch.ops import batched_core as bc

NUM_ACTIONS = 54
_CHUNKS = 11  # Philox blocks per ply (5 draws each: 55 >= 54 actions)
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit halves of ``m * x`` for uint32 values held in int64,
    via 16-bit limbs so no intermediate leaves int64's range."""
    ph = (x >> 16) * m          # < 2**48
    pl = (x & 0xFFFF) * m       # < 2**48
    lo = (pl + ((ph & 0xFFFF) << 16)) & _MASK32
    hi = (ph + (pl >> 16)) >> 16
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors holding uint32 words (broadcasting)."""
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_field(seed: int, num_steps: int, batch: int, device) -> torch.Tensor:
    """uint32[num_steps, 54, B]: ``draw << 8`` for each draw the kernel
    takes in Philox mode for ``seed`` (env fastest)."""
    dev = torch.device(device)
    k0 = seed & _MASK32
    k1 = torch.arange(batch, dtype=torch.int64, device=dev)[None]
    chunk = torch.arange(_CHUNKS, dtype=torch.int64, device=dev)[:, None].expand(_CHUNKS, batch)
    zero = torch.zeros((_CHUNKS, batch), dtype=torch.int64, device=dev)
    out = torch.empty((num_steps, NUM_ACTIONS, batch), dtype=torch.int32, device=dev)
    d24 = 0xFFFFFF
    for t in range(num_steps):
        x, y, z, w = philox4x32_10(zero + t, chunk, zero, zero, k0, k1)
        draws = torch.stack([x & d24, ((x >> 24) | (y << 8)) & d24,
                             ((y >> 16) | (z << 16)) & d24, z >> 8, w & d24], dim=1)
        words = draws.reshape(5 * _CHUNKS, batch)[:NUM_ACTIONS] << 8
        out[t] = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
    return out.view(torch.uint32)


def rollout_random_fused_plain(board: torch.Tensor, current: torch.Tensor,
                               num_steps: int, draws: torch.Tensor):
    """The kernel's function in batched tensor code, fed with the field
    ``draws`` (uint32 or int32 ``[num_steps, 54, B]``).  Same return
    contract as :func:`rollout_random_fused`."""
    dev = board.device
    ids = torch.arange(NUM_ACTIONS, dtype=torch.int32, device=dev)[:, None]
    eps = torch.zeros((), dtype=torch.int64, device=dev)
    w1 = torch.zeros((), dtype=torch.int64, device=dev)
    w2 = torch.zeros((), dtype=torch.int64, device=dev)
    cur = current
    for t in range(num_steps):
        mask = bc.legal_mask_planes(board, cur)
        bits = (draws[t].view(torch.int32) >> 8) & 0xFFFFFF     # 24-bit draws
        d = torch.where(mask, bits, -1)
        maxv = d.max(dim=0, keepdim=True).values
        action = torch.where(mask & (d == maxv), ids, 99).min(dim=0).values
        board = bc.apply_action_unchecked(board, cur, action)
        win = bc.winner_planes(bc.flat_planes(board))
        done = win != 0
        eps += done.sum()
        w1 += (win == 1).sum()
        w2 += (win == -1).sum()
        board = torch.where(done[None, None], 0, board)
        cur = torch.where(done, 0, 1 - cur)
    return board, cur, {"episodes": eps, "wins_p1": w1, "wins_p2": w2}


def _check(board, current, num_steps, draws) -> int:
    if not isinstance(num_steps, int) or num_steps < 0:
        raise ValueError(f"num_steps must be a non-negative int, got {num_steps!r}")
    batch = build.check_batch(board, current)
    if draws is not None:
        if draws.dtype not in (torch.uint32, torch.int32) or \
                tuple(draws.shape) != (num_steps, NUM_ACTIONS, batch):
            raise ValueError(f"draws must be uint32[{num_steps}, 54, {batch}], got "
                             f"{draws.dtype} {tuple(draws.shape)}")
        if draws.device != board.device:
            raise ValueError("board and draws must be on one device")
        if not draws.is_contiguous():
            raise ValueError("draws must be contiguous")
    return batch


def rollout_random_fused(board: torch.Tensor, current: torch.Tensor, num_steps: int,
                         seed: int = 0, draws: torch.Tensor | None = None):
    """Fused random rollout.

    Args:
      board: int8[3, 9, B] lane-major batch (any B).
      current: int32[B].
      num_steps: plies per environment.
      seed: Philox key word; the caller varies it between calls.
      draws: optional uint32[num_steps, 54, B] field read in place of Philox.
    Returns:
      ``(board' int8[3, 9, B], current' int32[B], stats)`` with int64 totals
      ``episodes``, ``wins_p1`` and ``wins_p2``.

    CUDA tensors launch the kernel (``rollout_random_fused.launches`` counts
    the launches); CPU tensors run :func:`rollout_random_fused_plain`, on
    :func:`philox_field` when ``draws`` is None.  Any other device raises.
    """
    batch = _check(board, current, num_steps, draws)
    if board.device.type == "cpu":
        if draws is None:
            draws = philox_field(seed, num_steps, batch, board.device)
        return rollout_random_fused_plain(board, current, num_steps, draws)
    if board.device.type != "cuda":
        raise ValueError(f"no rollout kernel for device {board.device}")

    board_out = torch.empty_like(board)
    cur_out = torch.empty_like(current)
    stats = torch.zeros(3, dtype=torch.int64, device=board.device)
    if batch > 0:
        build.launch("rollout", "rollout", "ppppppiiu", board.device, board, current, board_out,
                     cur_out, stats, draws, batch, num_steps, seed & _MASK32)
        rollout_random_fused.launches += 1
    return board_out, cur_out, {"episodes": stats[0], "wins_p1": stats[1],
                                "wins_p2": stats[2]}


rollout_random_fused.launches = 0
