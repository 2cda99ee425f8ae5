"""Lane-major (batch-last) PUCT MCTS.

Port of ``gobblet_rl_tpu/search/mcts_lm.py``: the algorithm of
:mod:`gobblet_rl_torch.search.mcts` on the tree arrays and loops of
:mod:`gobblet_rl_torch.search.gumbel_lm` (``[M, 54, B]``, row gathers,
``index_put_`` backups, loops bounded by the tree's depth).
"""

from __future__ import annotations

import torch

from gobblet_rl_torch.core.types import NUM_ACTIONS as A
from gobblet_rl_torch.ops import batched_core as bc
from gobblet_rl_torch.search.gumbel_lm import _evaluate_lm, _row, _Tree, _winning_actions_lm
from gobblet_rl_torch.search.mcts import MCTSConfig, select_root_action


@torch.no_grad()
def mcts_search_lm(net, board_lm: torch.Tensor, players: torch.Tensor,
                   generator: torch.Generator | None, config: MCTSConfig,
                   dirichlet: torch.Tensor | None = None):
    """Batched PUCT search over lane-major roots.

    ``board_lm`` int8[3, 9, B], ``players`` int32[B] -> (visits f32[B, 54],
    q f32[B, 54], root_win bool[B, 54]) — the contract of
    :func:`gobblet_rl_torch.search.mcts.mcts_search`.

    With ``config.dirichlet_alpha > 0`` the root priors are mixed with
    Dirichlet noise: gamma draws f32[54, B] from ``generator``, or the
    field ``dirichlet``."""
    B, dev = players.shape[0], players.device
    tree = _Tree(config.num_sims, board_lm, players)
    N, W = tree.N, tree.W

    priors0, _, mask0 = _evaluate_lm(net, board_lm, players)
    if config.dirichlet_alpha > 0:
        g = dirichlet
        if g is None:
            alpha = torch.full((A, B), config.dirichlet_alpha, device=dev)
            g = torch._standard_gamma(alpha, generator=generator)
        g = torch.where(mask0, g, 0.0)
        noise = g / g.sum(0).clamp(min=1e-9)
        priors0 = (1.0 - config.noise_frac) * priors0 + config.noise_frac * noise
    tree.P[0], tree.legal[0] = priors0, mask0

    def puct_action(node):
        n, w, p, m = _row(N, node), _row(W, node), _row(tree.P, node), _row(tree.legal, node)
        q = torch.where(n > 0, w / n.clamp(min=1.0), 0.0)
        u = config.c_puct * p * torch.sqrt(n.sum(0).clamp(min=1.0)) / (1.0 + n)
        return torch.where(m, q + u, -torch.inf).argmax(0)

    root = torch.zeros(B, dtype=torch.int64, device=dev)
    for sim in range(config.num_sims):
        trips = min(sim, config.max_depth)
        node, action = tree.descend(puct_action(root), puct_action, trips)
        start, value = tree.expand(sim, node, action, net)
        tree.backup(start, value, trips + 1)

    n0, w0 = N[0], W[0]
    root_q = torch.where(n0 > 0, w0 / n0.clamp(min=1.0), -torch.inf)
    root_win = _winning_actions_lm(board_lm, players)
    return n0.t(), root_q.t(), root_win.t()


def mcts_lm_policy(net, config: MCTSConfig = MCTSConfig()):
    """Tournament policy ``(generator, board_lm [3, 9, B], current [B]) ->
    int32[B]``: the final selection of :func:`mcts.mcts_policy`."""

    def fn(generator, board_lm, current):
        visits, q, root_win = mcts_search_lm(net, board_lm, current, generator, config)
        mask = bc.legal_mask_planes(board_lm, current).t()
        return select_root_action(visits, q, root_win, mask, generator, config.temperature)

    return fn
