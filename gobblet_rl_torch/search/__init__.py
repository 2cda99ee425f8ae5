from gobblet_rl_torch.search.gumbel import GumbelConfig, gumbel_policy, gumbel_search
from gobblet_rl_torch.search.gumbel_lm import gumbel_lm_policy, gumbel_search_lm
from gobblet_rl_torch.search.mcts import MCTSConfig, mcts_policy, mcts_search
from gobblet_rl_torch.search.mcts_lm import mcts_lm_policy, mcts_search_lm

__all__ = [
    "MCTSConfig",
    "mcts_search",
    "mcts_policy",
    "mcts_search_lm",
    "mcts_lm_policy",
    "GumbelConfig",
    "gumbel_search",
    "gumbel_policy",
    "gumbel_search_lm",
    "gumbel_lm_policy",
]
