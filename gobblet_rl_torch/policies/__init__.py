from gobblet_rl_torch.policies.alphabeta import AlphaBetaGobbletPolicy
from gobblet_rl_torch.policies.greedy import GreedyGobbletPolicy
from gobblet_rl_torch.policies.random_policy import (
    RandomAdmissiblePolicy,
    batched_random_admissible,
    random_admissible_action,
)

__all__ = [
    "AlphaBetaGobbletPolicy",
    "GreedyGobbletPolicy",
    "RandomAdmissiblePolicy",
    "batched_random_admissible",
    "random_admissible_action",
]
