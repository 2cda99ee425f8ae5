"""Batched vector environment over the lane-major engine.

Port of ``gobblet_rl_tpu/env/vector.py``.  B environments live as one
:class:`~gobblet_rl_torch.ops.batched_core.PlanesState`; this module adds
the user-facing contract on top: batch-first observations in the reference
layout ``int8[B, 3, 3, 13]`` and ``bool[B, 54]`` legal masks.  Code that
wants the most throughput uses ``batched_core`` directly and skips the
layout changes.

Each step is one ply by each env's own ``current`` player.  An illegal
action ends the game with -1 for the mover (terminate-illegal); with
``auto_reset`` finished games restart in the same step.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from gobblet_rl_torch.ops import batched_core as bc
from gobblet_rl_torch.ops.batched_core import PlanesState


class TimeStep(NamedTuple):
    """Per-step batch outputs (batch-first, reference observation layout)."""

    obs: torch.Tensor      # int8[B, 3, 3, 13] — mover's observation
    mask: torch.Tensor     # bool[B, 54] — mover's legal mask
    current: torch.Tensor  # int32[B] — player to move in the NEW state
    rewards: torch.Tensor  # float32[B, 2] — rewards emitted by this step
    done: torch.Tensor     # bool[B] — episode ended at this step
    winner: torch.Tensor   # int8[B]
    turn: torch.Tensor     # int32[B] — turn counter of the new state


def _timestep(state: PlanesState, rewards_lm, done, winner) -> TimeStep:
    planes = bc.observe_planes_lm(state.board, state.current)
    return TimeStep(
        obs=bc.to_reference_obs(planes),
        mask=bc.legal_mask_planes(state.board, state.current).t(),
        current=state.current,
        rewards=rewards_lm.t(),
        done=done,
        winner=winner,
        turn=state.turn,
    )


def vector_reset(num_envs: int, device=None) -> tuple[PlanesState, TimeStep]:
    """Fresh games on ``device`` (``None``: the CUDA card, or raise)."""
    state = bc.reset_planes(num_envs, device)
    zero_r = torch.zeros((2, num_envs), dtype=torch.float32, device=state.board.device)
    return state, _timestep(state, zero_r, state.done, state.winner)


def vector_step(state: PlanesState, actions: torch.Tensor,
                auto_reset: bool = True) -> tuple[PlanesState, TimeStep]:
    """One batched ply; with ``auto_reset`` finished games restart at once
    (the returned TimeStep still reports the terminal reward, done and
    winner)."""
    stepped = bc.step_planes(state, actions)
    out = bc.autoreset_planes(stepped) if auto_reset else stepped
    return out, _timestep(out, stepped.rewards, stepped.done, stepped.winner)


class VectorGobbletEnv:
    """Thin object wrapper for users who prefer an env object."""

    def __init__(self, num_envs: int, auto_reset: bool = True, device=None):
        self.num_envs = num_envs
        self.auto_reset = auto_reset
        self.device = device

    def reset(self):
        return vector_reset(self.num_envs, self.device)

    def step(self, state, actions):
        return vector_step(state, actions, self.auto_reset)


# ---------------------------------------------------------------------------
# Rollout: policy + step, one ply at a time
# ---------------------------------------------------------------------------
PolicyFn = Callable[[torch.Generator, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
# signature: (generator, obs[B,3,3,13], mask[B,54], current[B]) -> actions int32[B]


def random_policy(generator, obs, mask, current):
    """Uniform over the legal actions (a Gumbel argmax over the mask)."""
    return bc.sample_random_lm(generator, mask.t())


def rollout(state: PlanesState, generator: torch.Generator | None, first_ts: TimeStep,
            policy_fn: PolicyFn, num_steps: int, collect: bool = False):
    """Run ``num_steps`` plies with auto-reset; ``generator`` advances in
    place.

    Returns ``(final_state, final_ts, out)`` where ``out`` holds the int64
    totals ``episodes``, ``wins_p1`` and ``wins_p2`` or, with
    ``collect=True``, the per-step TimeSteps stacked along a new first
    axis."""
    ts = first_ts
    steps = []
    dev = state.board.device
    episodes, w1, w2 = (torch.zeros((), dtype=torch.int64, device=dev) for _ in range(3))
    for _ in range(num_steps):
        actions = policy_fn(generator, ts.obs, ts.mask, ts.current)
        state, ts = vector_step(state, actions)
        if collect:
            steps.append(ts)
        else:
            episodes += ts.done.sum()
            w1 += (ts.winner == 1).sum()
            w2 += (ts.winner == -1).sum()
    if collect:
        return state, ts, TimeStep(*(torch.stack(x) for x in zip(*steps)))
    return state, ts, {"episodes": episodes, "wins_p1": w1, "wins_p2": w2}
