"""Gumbel MCTS (sequential halving at the root): configuration, host
tables, and the batch-first entry points.

Port of ``gobblet_rl_tpu/search/gumbel.py`` (Danihelka et al., ICLR 2022):

* root: Gumbel noise ``g[54]``; the initial candidate set is the top
  ``max_considered`` legal actions by ``g + logits``; simulations go
  round-robin to the candidates (fewest visits first) and the set is
  halved between phases, ranked by ``g + logits + sigma(q)`` with
  ``sigma(q) = (c_visit + max_N) * c_scale * q``;
* interior nodes: deterministic selection by the improved policy
  ``argmax pi'(a) - N(a) / (1 + sum N)``, ``pi' = softmax(logits +
  sigma(completedQ))``;
* the training target is the improved policy at the root with completed
  Q-values (the mixed-value estimator for unvisited actions), and the
  root's mixed value is returned as a bootstrap value target.

The JAX module's search is a ``vmap`` of a per-root ``while_loop``
(``gumbel_search_single``).  PyTorch has no ``vmap`` of a data-dependent
loop, so here :func:`gumbel_search` is the lane-major search of
:mod:`gobblet_rl_torch.search.gumbel_lm` on transposed boards, with the
batch-first contract.  The JAX package pins the two searches bit-identical
under a shared noise field (``tests/test_gumbel_lm.py``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class GumbelConfig:
    num_sims: int = 32
    max_considered: int = 16   # initial root candidate count (m)
    c_visit: float = 50.0
    c_scale: float = 0.1


def _phase_table(num_sims: int, max_considered: int) -> np.ndarray:
    """Static per-simulation phase index for sequential halving.

    Phase p considers max(2, m >> p) candidates; the budget is split evenly
    over phases (the remainder goes to the last phase)."""
    m = max(2, max_considered)
    phases = max(1, int(math.ceil(math.log2(m))))
    per = max(1, num_sims // phases)
    table = np.minimum(np.arange(num_sims) // per, phases - 1)
    return table.astype(np.int32)


def _considered_counts(max_considered: int, num_phases: int) -> np.ndarray:
    m = max(2, max_considered)
    return np.array([max(2, m >> p) for p in range(num_phases)], np.int32)


def _sigma(q: torch.Tensor, max_n: torch.Tensor, config: GumbelConfig) -> torch.Tensor:
    return (config.c_visit + max_n) * config.c_scale * q


def _mixed_value(v_hat, q, n, priors, legal, dim: int = -1):
    """The paper's mixed-value estimator (Danihelka et al. 2022, App. D)
    over the action axis ``dim``:
    ``(v_hat + sum_N * (sum_{N>0} pi q / sum_{N>0} pi)) / (1 + sum_N)``,
    falling back to the raw network value when nothing is visited."""
    visited = (n > 0) & legal
    pi = torch.where(legal, priors, 0.0)
    pi = pi / pi.sum(dim, keepdim=True).clamp(min=1e-12)
    w_vis = torch.where(visited, pi, 0.0).sum(dim)
    q_avg = torch.where(visited, pi * q, 0.0).sum(dim) / w_vis.clamp(min=1e-12)
    sum_n = n.sum(dim)
    v_mix = (v_hat + sum_n * q_avg) / (1.0 + sum_n)
    return torch.where(w_vis > 0, v_mix, v_hat)


def gumbel_search(net, boards_bf: torch.Tensor, players: torch.Tensor,
                  generator: torch.Generator | None, config: GumbelConfig,
                  noise: torch.Tensor | None = None):
    """Batch-first search: ``boards_bf`` int8[B, 3, 9], ``players``
    int32[B] -> (actions int32[B], pi f32[B, 54], q f32[B, 54], visits
    f32[B, 54], root_value f32[B] — the mixed value from the mover's
    perspective).

    ``noise`` (f32[B, 54], optional) replaces the root Gumbel draw."""
    from gobblet_rl_torch.search.gumbel_lm import gumbel_search_lm

    return gumbel_search_lm(net, boards_bf.permute(1, 2, 0), players, generator, config,
                            noise=None if noise is None else noise.t())


def gumbel_policy(net, config: GumbelConfig = GumbelConfig()):
    """Tournament policy ``(generator, board_lm [3, 9, B], current [B]) ->
    int32[B]`` (see eval/tournament.py)."""

    def fn(generator, board_lm, current):
        return gumbel_search(net, board_lm.permute(2, 0, 1), current, generator, config)[0]

    return fn
