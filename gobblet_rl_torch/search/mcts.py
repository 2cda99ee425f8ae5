"""Batched Monte-Carlo tree search (AlphaZero-style PUCT): configuration
and the batch-first entry points.

Port of ``gobblet_rl_tpu/search/mcts.py``.  A simulation selects by PUCT
(``Q + c_puct * P * sqrt(sum N) / (1 + N)``, illegal actions at -inf) down
to an unexpanded edge or a proven node, expands with the net's
masked-softmax priors and tanh value (a proven node — game over, or its
mover wins in one — takes the exact value -1 or +1 and is never descended
past), and backs up with a sign flip per ply.  Self-play may mix
Dirichlet(alpha) noise into the root priors.

The JAX module's search is a ``vmap`` of a per-root ``while_loop``
(``mcts_search_single``).  Here :func:`mcts_search` is the lane-major
search of :mod:`gobblet_rl_torch.search.mcts_lm` on transposed boards,
with the batch-first contract; without root noise the JAX package pins the
two bit-identical (``tests/test_mcts_lm.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from gobblet_rl_torch.ops import batched_core as bc


@dataclasses.dataclass(frozen=True)
class MCTSConfig:
    num_sims: int = 64
    c_puct: float = 1.5
    max_depth: int = 40           # select-path cap (games are short)
    temperature: float = 0.0      # 0 = argmax visits; > 0 = sample visits^(1/t)
    # AlphaZero root exploration noise (self-play only): the root priors
    # are mixed with Dirichlet(alpha) noise over the legal actions
    dirichlet_alpha: float = 0.0  # 0 = off
    noise_frac: float = 0.25


def mcts_search(net, boards_bf: torch.Tensor, players: torch.Tensor,
                generator: torch.Generator | None, config: MCTSConfig,
                dirichlet: torch.Tensor | None = None):
    """Batch-first search: ``boards_bf`` int8[B, 3, 9], ``players``
    int32[B] -> (visits f32[B, 54], q f32[B, 54], root_win bool[B, 54]).

    ``dirichlet`` (f32[B, 54], optional) replaces the root's gamma draws."""
    from gobblet_rl_torch.search.mcts_lm import mcts_search_lm

    return mcts_search_lm(net, boards_bf.permute(1, 2, 0), players, generator, config,
                          dirichlet=None if dirichlet is None else dirichlet.t())


def select_root_action(visits, q, root_win, mask_bf, generator, temperature: float):
    """The evaluation policy's move: exact 1-ply wins first, then
    search-proven wins (q = +1 is proof: net values are tanh-bounded), then
    visits, with search-proven losses avoided and never an illegal action;
    with ``temperature > 0`` sampled from visits^(1/t)."""
    score = (visits + 1e9 * root_win + 1e6 * (q >= 0.999)
             - 1e6 * (torch.isfinite(q) & (q <= -0.999)))
    score = torch.where(mask_bf, score, -torch.inf)
    if temperature > 0:
        logits = torch.log(score.clamp(min=1e-9)) / temperature
        return (logits + bc.gumbel_field(generator, logits.shape, logits.device)).argmax(-1).to(torch.int32)
    return score.argmax(-1).to(torch.int32)


def mcts_policy(net, config: MCTSConfig = MCTSConfig()):
    """Tournament policy ``(generator, board_lm [3, 9, B], current [B]) ->
    int32[B]`` (see eval/tournament.py)."""

    def fn(generator, board_lm, current):
        visits, q, root_win = mcts_search(net, board_lm.permute(2, 0, 1), current, generator,
                                          config)
        mask = bc.legal_mask_planes(board_lm, current).t()
        return select_root_action(visits, q, root_win, mask, generator, config.temperature)

    return fn
