"""RLlib adapters: the greedy and the random-admissible policy.

Port of ``gobblet_rl_tpu/adapters/rllib_adapter.py``: the reference's
``greedy_policy_rllib.py`` and ``random_admissible_policy_rllib.py``.
Needs ``ray[rllib]``; the framework-free PPO pipeline is
``train/ppo.py``.
"""

from __future__ import annotations

import numpy as np

try:
    from ray.rllib.examples.policy.random_policy import RandomPolicy
    from ray.rllib.utils.annotations import override
except ImportError as e:  # pragma: no cover
    raise ImportError(
        "ray[rllib] is not installed; use gobblet_rl_torch.train.ppo for the "
        "framework-free PPO pipeline"
    ) from e

from gobblet_rl_torch.policies.greedy import GreedyGobbletPolicy


class GreedyPolicy(RandomPolicy):
    """Depth-1 greedy as an RLlib policy (greedy_policy_rllib.py:11-30)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.policy = GreedyGobbletPolicy(seed=np.random.randint(1000), depth=1)

    @override(RandomPolicy)
    def compute_actions(self, obs_batch, state_batches=None,
                        prev_action_batch=None, prev_reward_batch=None,
                        **kwargs):
        actions = self.policy.compute_actions_rllib(obs_batch)
        return actions, [], {}


class RandomAdmissiblePolicy(RandomPolicy):
    """Uniform over the action mask (random_admissible_policy_rllib.py:10-40)."""

    @override(RandomPolicy)
    def compute_actions(self, obs_batch, state_batches=None,
                        prev_action_batch=None, prev_reward_batch=None,
                        **kwargs):
        masks = obs_batch["action_mask"]
        actions = [
            int(np.random.choice(np.nonzero(np.asarray(m).flatten())[0]))
            for m in masks
        ]
        return actions, [], {}
