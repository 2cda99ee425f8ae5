"""Tianshou adapters: the greedy as a ``BasePolicy`` and a collector that
steps once with a given action.

Port of ``gobblet_rl_tpu/adapters/tianshou_adapter.py``: the reference's
``greedy_policy_tianshou.GreedyPolicy`` and
``collector_manual_policy.ManualPolicyCollector``.  Needs ``tianshou``;
``interactive.session.GameSession`` is the framework-free path the
examples use.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

try:
    from tianshou.data import Batch
    from tianshou.data.collector import Collector
    from tianshou.policy import BasePolicy
except ImportError as e:  # pragma: no cover
    raise ImportError(
        "tianshou is not installed; use gobblet_rl_torch.interactive.session."
        "GameSession and gobblet_rl_torch.policies instead"
    ) from e

from gobblet_rl_torch.policies.greedy import GreedyGobbletPolicy


class GreedyPolicy(BasePolicy):
    """Greedy search wrapped as a Tianshou policy (greedy_policy_tianshou.py:12)."""

    def __init__(self, depth: Optional[int] = 2, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.depth = depth
        self.policy = GreedyGobbletPolicy(depth=depth)

    def forward(self, batch: "Batch", state=None, input: str = "obs", **kwargs):
        obs_batch = batch[input]
        obs = np.asarray(obs_batch.obs)
        mask = np.asarray(obs_batch.mask)
        if obs.ndim == 3:
            obs, mask = obs[None], mask[None]
        acts = np.array(
            [self.policy.compute_action(obs[i], mask[i]) for i in range(len(obs))]
        )
        return Batch(act=acts)

    def learn(self, batch: "Batch", **kwargs: Any) -> Dict[str, float]:
        return {}


class ManualPolicyCollector(Collector):
    """Collector whose ``collect_result(action)`` performs exactly one env
    step with a caller-supplied action (collector_manual_policy.py:25-180)."""

    def __init__(self, policy, env, buffer=None, preprocess_fn=None,
                 exploration_noise: bool = False) -> None:
        super().__init__(policy, env, buffer, preprocess_fn, exploration_noise)

    def collect_result(self, action, render: Optional[float] = None):
        self.data.act = np.asarray(action).reshape(1)
        result = self.env.step(self.data.act, ready_env_ids=np.array([0]))
        if len(result) == 5:
            obs_next, rew, terminated, truncated, info = result
            done = np.logical_or(terminated, truncated)
        else:
            obs_next, rew, done, info = result

        self.data.update(obs_next=obs_next, rew=rew, done=done, info=info)
        ptr, ep_rew, ep_len, ep_idx = self.buffer.add(
            self.data, buffer_ids=np.array([0])
        )

        episode_count = int(done.sum())
        if episode_count > 0:
            rews, lens, idxs = ep_rew[done], ep_len[done], ep_idx[done]
            obs_reset = self.env.reset(np.where(done)[0])
            if isinstance(obs_reset, tuple):
                obs_reset = obs_reset[0]
            self.data.obs_next = obs_reset
        else:
            rews = np.array([], dtype=np.float64)
            lens = np.array([], dtype=np.int64)
            idxs = np.array([], dtype=np.int64)

        self.data.obs = self.data.obs_next
        if render:
            import time

            time.sleep(render)

        return {
            "n/ep": episode_count,
            "n/st": 1,
            "rews": rews,
            "lens": lens,
            "idxs": idxs,
            "rew": rews.mean() if episode_count else 0,
            "len": lens.mean() if episode_count else 0,
            "rew_std": rews.std() if episode_count else 0,
            "len_std": lens.std() if episode_count else 0,
        }
