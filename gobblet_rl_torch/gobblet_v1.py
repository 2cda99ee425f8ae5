"""Versioned namespace of the reference's ``gobblet_rl.gobblet_v1``, on the
host.

Port of ``gobblet_rl_tpu/gobblet_v1.py``.  It imports ``pettingzoo`` and
``gymnasium``, which the card's path never needs.  ``ManualGobbletPolicy``
(the pygame manual policy) is imported when it is first read.
"""

from gobblet_rl_torch.env.aec import env, parallel_env, raw_env
from gobblet_rl_torch.policies.greedy import GreedyGobbletPolicy

__all__ = ["env", "parallel_env", "raw_env", "GreedyGobbletPolicy", "ManualGobbletPolicy"]


def __getattr__(name):
    if name == "ManualGobbletPolicy":
        from gobblet_rl_torch.interactive.manual_policy import ManualGobbletPolicy

        return ManualGobbletPolicy
    raise AttributeError(f"module 'gobblet_rl_torch.gobblet_v1' has no attribute {name!r}")
