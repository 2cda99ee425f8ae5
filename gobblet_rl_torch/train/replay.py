"""Device-resident uniform replay ring of n-step transitions.

Port of ``gobblet_rl_tpu/train/replay.py``: the state ring the trainer
uses, and the feature-space ``Segment`` folds that specify what its n-step
rows mean.  A ring row is the raw game state, not derived features:
(board int8[27], current int8, action int32, reward_n float32, done_n
bool, next board int8[27], next current int8), 65 B.  Observations and
legal masks are recomputed from the snapshots at sample time,
bit-identical to what the collector saw.

n-step returns are folded at insert time from the collected segment
(terminal-only rewards); the bootstrap ``gamma^n Q_target(s_{t+n})`` is
applied at sample time with the current target network.

The ring is written IN PLACE: :func:`insert_rows` copies into the buffer's
tensors and returns the buffer with its new cursor, so a full-width ring is
never held twice.  ``cursor`` and ``filled`` are host integers, so the
branch choice costs no device sync.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gobblet_rl_torch.device import resolve_device
from gobblet_rl_torch.ops import batched_core as bc


class ReplayBuffer(NamedTuple):
    board: torch.Tensor      # int8[N, 27] — board at s_t, level-major
    current: torch.Tensor    # int8[N] — player to move at s_t
    action: torch.Tensor     # int32[N]
    reward_n: torch.Tensor   # float32[N] — folded n-step reward
    done_n: torch.Tensor     # bool[N] — episode ended within the window
    board_n: torch.Tensor    # int8[N, 27] — board at bootstrap state s_{t+n}
    current_n: torch.Tensor  # int8[N] — player to move at s_{t+n}
    cursor: int              # next write position
    filled: int              # number of valid rows


def make_buffer(capacity: int, device=None) -> ReplayBuffer:
    dev = resolve_device(device)
    return ReplayBuffer(
        board=torch.zeros((capacity, 27), dtype=torch.int8, device=dev),
        current=torch.zeros(capacity, dtype=torch.int8, device=dev),
        action=torch.zeros(capacity, dtype=torch.int32, device=dev),
        reward_n=torch.zeros(capacity, dtype=torch.float32, device=dev),
        done_n=torch.zeros(capacity, dtype=torch.bool, device=dev),
        board_n=torch.zeros((capacity, 27), dtype=torch.int8, device=dev),
        current_n=torch.zeros(capacity, dtype=torch.int8, device=dev),
        cursor=0,
        filled=0,
    )


class Segment(NamedTuple):
    """A collected segment of derived features, time-major and batch-first.
    The reference semantics of the n-step fold; the trainer itself stores
    :class:`StateSegment` rows."""

    obs: torch.Tensor        # int8[L, B, 117]
    action: torch.Tensor     # int32[L, B]
    reward: torch.Tensor     # float32[L, B] — learner-perspective reward
    done: torch.Tensor       # bool[L, B]
    obs_next: torch.Tensor   # int8[L, B, 117]
    mask_next: torch.Tensor  # bool[L, B, 54]


def nstep_fold(seg: Segment, n_step: int, gamma: float) -> Segment:
    """Fold a segment into n-step transitions; the tail positions truncate
    to the horizon the segment holds, and the bootstrap observation stays
    at the step where the episode ended."""
    reward_n, done_n = seg.reward, seg.done
    obs_n, mask_n = seg.obs_next, seg.mask_next
    discount = gamma
    for k in range(1, n_step):
        # shift by k, padding the tail with zero rewards and finished steps
        r_k = torch.cat([seg.reward[k:], torch.zeros_like(seg.reward[:k])])
        d_k = torch.cat([seg.done[k:], torch.ones_like(seg.done[:k])])
        o_k = torch.cat([seg.obs_next[k:], seg.obs_next[-1:].expand(k, -1, -1)])
        m_k = torch.cat([seg.mask_next[k:], seg.mask_next[-1:].expand(k, -1, -1)])
        live = ~done_n  # the episode still runs after the earlier steps
        reward_n = reward_n + discount * live * r_k
        obs_n = torch.where(live[..., None], o_k, obs_n)
        mask_n = torch.where(live[..., None], m_k, mask_n)
        done_n = done_n | d_k
        discount *= gamma
    return Segment(seg.obs, seg.action, reward_n, done_n, obs_n, mask_n)


class CompactSegment(NamedTuple):
    """Feature-space segment whose ``obs``/``mask`` carry L+1 entries, so
    ``obs_next[t]`` is ``obs[t+1]``; the fold-equivalence spec."""

    obs: torch.Tensor     # int8[L+1, B, 117]
    mask: torch.Tensor    # bool[L+1, B, 54]
    action: torch.Tensor  # int32[L, B]
    reward: torch.Tensor  # float32[L, B]
    done: torch.Tensor    # bool[L, B]


def nstep_fold_compact(cseg: CompactSegment, n_step: int, gamma: float,
                       segment_len: int) -> Segment:
    """Fold a compact segment of length L = segment_len + n_step - 1 into
    ``segment_len`` n-step transitions.  ``reward``/``done`` equal
    :func:`nstep_fold`'s; ``obs_next``/``mask_next`` differ only on rows
    whose ``done`` is set (the post-reset state), whose bootstrap the TD
    target multiplies by zero."""
    S = segment_len
    reward_n, done_n = _fold_scalars(cseg.reward, cseg.done, n_step, gamma, S)
    return Segment(
        obs=cseg.obs[:S],
        action=cseg.action[:S],
        reward=reward_n,
        done=done_n,
        obs_next=cseg.obs[n_step:S + n_step],
        mask_next=cseg.mask[n_step:S + n_step],
    )


class StateSegment(NamedTuple):
    """A collected rollout as raw states, lane-major; ``board``/``current``
    carry L+1 entries (every visited state including the final one)."""

    board: torch.Tensor    # int8[L+1, 3, 9, B]
    current: torch.Tensor  # int32[L+1, B]
    action: torch.Tensor   # int32[L, B]
    reward: torch.Tensor   # float32[L, B]
    done: torch.Tensor     # bool[L, B]


class TransitionBatch(NamedTuple):
    """n-step transitions in buffer-row layout (batch-first, boards flat)."""

    board: torch.Tensor      # int8[n, 27]
    current: torch.Tensor    # int8[n]
    action: torch.Tensor     # int32[n]
    reward_n: torch.Tensor   # float32[n]
    done_n: torch.Tensor     # bool[n]
    board_n: torch.Tensor    # int8[n, 27]
    current_n: torch.Tensor  # int8[n]


def _fold_scalars(reward, done, n_step: int, gamma: float, segment_len: int):
    """n-step reward/done fold over L = segment_len + n_step - 1 rows."""
    S = segment_len
    reward_n = reward[:S]
    done_n = done[:S]
    discount = gamma
    for k in range(1, n_step):
        live = ~done_n
        reward_n = reward_n + discount * live * reward[k:S + k]
        done_n = done_n | done[k:S + k]
        discount *= gamma
    return reward_n, done_n


def _rows(board_lm: torch.Tensor, current: torch.Tensor):
    """[S, 3, 9, B] boards + [S, B] players -> (int8[S*B, 27], int8[S*B])
    with flat row index t*B + b."""
    S, _, _, B = board_lm.shape
    board = board_lm.permute(0, 3, 1, 2).reshape(S * B, 27)
    return board, current.to(torch.int8).reshape(S * B)


def nstep_fold_state(sseg: StateSegment, n_step: int, gamma: float,
                     segment_len: int) -> TransitionBatch:
    """Fold a state segment of length L = segment_len + n_step - 1 into
    ``segment_len`` n-step rows; the bootstrap state is the snapshot at t+n
    (post-reset where the episode ended, rows the TD target zeroes)."""
    S = segment_len
    reward_n, done_n = _fold_scalars(sseg.reward, sseg.done, n_step, gamma, S)
    board, current = _rows(sseg.board[:S], sseg.current[:S])
    board_n, current_n = _rows(sseg.board[n_step:S + n_step], sseg.current[n_step:S + n_step])
    return TransitionBatch(
        board=board,
        current=current,
        action=sseg.action[:S].reshape(-1),
        reward_n=reward_n.reshape(-1),
        done_n=done_n.reshape(-1),
        board_n=board_n,
        current_n=current_n,
    )


def insert_rows(buffer: ReplayBuffer, rows: TransitionBatch) -> ReplayBuffer:
    """Write all rows round-robin from the cursor, in place.

    An insert of at least ``capacity`` rows keeps the newest ``capacity``,
    oldest first, and resets the cursor to 0 so the next write evicts the
    oldest row.  Otherwise the write is one contiguous copy, or two where it
    wraps past the end."""
    count = rows.action.shape[0]
    capacity = buffer.board.shape[0]
    filled = min(buffer.filled + count, capacity)
    dsts = [getattr(buffer, name) for name in TransitionBatch._fields]
    if count >= capacity:
        for dst, data in zip(dsts, rows):
            dst.copy_(data[count - capacity:])
        return buffer._replace(cursor=0, filled=filled)
    start = buffer.cursor
    head = min(count, capacity - start)
    for dst, data in zip(dsts, rows):
        dst[start:start + head].copy_(data[:head])
        dst[:count - head].copy_(data[head:])
    return buffer._replace(cursor=(start + count) % capacity, filled=filled)


def insert_segment(buffer: ReplayBuffer, sseg: StateSegment, n_step: int, gamma: float,
                   segment_len: int) -> ReplayBuffer:
    """Fold + insert a collected state segment (the training hot path)."""
    return insert_rows(buffer, nstep_fold_state(sseg, n_step, gamma, segment_len))


def derive_features(board_rows: torch.Tensor, current_rows: torch.Tensor):
    """(int8[n, 27] boards, int8[n] players) -> (obs int8[n, 117],
    mask bool[n, 54]), bit-identical to what the collector computed."""
    board_lm = board_rows.t().reshape(3, 9, -1)
    current = current_rows.to(torch.int32)
    obs = bc.features_lm(board_lm, current).t()
    mask = bc.legal_mask_planes(board_lm, current).t()
    return obs, mask


def sample(buffer: ReplayBuffer, generator: torch.Generator, batch_size: int):
    """Uniform minibatch over the filled prefix: ``(obs, action, reward_n,
    done_n, obs_n, mask_n)``, features derived from the stored snapshots."""
    idx = torch.randint(0, max(buffer.filled, 1), (batch_size,), generator=generator,
                        device=buffer.board.device)
    obs, _ = derive_features(buffer.board[idx], buffer.current[idx])
    obs_n, mask_n = derive_features(buffer.board_n[idx], buffer.current_n[idx])
    return (obs, buffer.action[idx], buffer.reward_n[idx], buffer.done_n[idx], obs_n, mask_n)
