"""Framework-free interactive game session.

Port of ``gobblet_rl_tpu/interactive/session.py``.  It replaces the
reference's Tianshou plumbing for human-vs-agent play (a ``Collector``
subclass whose ``collect_result(action)`` forces exactly one env step)
with a direct driver over the wrapped AEC env.  ``collect_result`` returns
the statistics dict the reference collector produced.  An illegal move
ends the game (the ``TerminateIllegalWrapper``): reward -1 for the
offender, the board unchanged, one finished episode in the result.
"""

from __future__ import annotations

import numpy as np


class GameSession:
    """One wrapped AEC env + per-agent policies, stepped one action at a time."""

    def __init__(self, env, policies=None):
        self.env = env
        self.policies = policies or {}
        self.episode_rewards: list[float] = []
        self.episode_lengths: list[int] = []
        self._steps_in_episode = 0
        env.reset()

    # -- accessors -------------------------------------------------------
    @property
    def agents(self):
        return self.env.agents

    def last(self):
        return self.env.last()

    def current_agent(self):
        return self.env.agent_selection

    def observation(self):
        obs, _, _, _, _ = self.env.last()
        return obs

    # -- stepping --------------------------------------------------------
    def collect_result(self, action, render: float = 0.0):
        """Force exactly one env step with ``action``; auto-reset on episode
        end.  Returns the reference collector's stats dict
        (collector_manual_policy.py:78-180)."""
        action = int(np.asarray(action).reshape(-1)[0])
        mover = self.env.agent_selection
        self.env.step(action)
        self._steps_in_episode += 1

        finished = all(self.env.terminations.values()) or all(
            self.env.truncations.values()
        )
        rews, lens, idxs = [], [], []
        if finished:
            reward = self.env._cumulative_rewards.get(mover, 0)
            rews.append(float(reward))
            lens.append(self._steps_in_episode)
            idxs.append(0)
            self.episode_rewards.append(float(reward))
            self.episode_lengths.append(self._steps_in_episode)
            self._steps_in_episode = 0
            self.env.reset()

        if render:
            import time

            time.sleep(render)

        rews_arr = np.array(rews, dtype=np.float64)
        lens_arr = np.array(lens, dtype=np.int64)
        return {
            "n/ep": len(rews),
            "n/st": 1,
            "rews": rews_arr,
            "lens": lens_arr,
            "idxs": np.array(idxs, dtype=np.int64),
            "rew": rews_arr.mean() if len(rews) else 0,
            "len": lens_arr.mean() if len(lens) else 0,
            "rew_std": rews_arr.std() if len(rews) else 0,
            "len_std": lens_arr.std() if len(lens) else 0,
        }

    def collect(self, n_step: int = 1, render: float = 0.0):
        """Let the registered policy for the current agent act ``n_step``
        times (the CPU-turn path of the reference play loop,
        example_tianshou_DQN.py:574)."""
        result = None
        for _ in range(n_step):
            obs, _, term, trunc, _ = self.env.last()
            if term or trunc:
                self.env.step(None)
                continue
            agent = self.env.agent_selection
            policy = self.policies[agent]
            action = policy.compute_action(obs["observation"], obs["action_mask"])
            result = self.collect_result(np.asarray(action), render=render)
        return result
