"""Batched matches between policies over the lane-major engine.

Port of part of ``gobblet_rl_tpu/eval/tournament.py``: the random, greedy
and DQN policies and :func:`play_match`.  A policy is a function
``(generator, board int8[3, 9, B], current int32[B]) -> int32[B]``.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from gobblet_rl_torch.device import resolve_device
from gobblet_rl_torch.models.mlp import masked_argmax
from gobblet_rl_torch.ops import batched_core as bc
from gobblet_rl_torch.policies import greedy_jax

PolicyFn = Callable[[torch.Generator, torch.Tensor, torch.Tensor], torch.Tensor]


def random_policy() -> PolicyFn:
    def fn(generator, board, current):
        return bc.sample_random_lm(generator, bc.legal_mask_planes(board, current))

    return fn


def greedy_policy(depth: int = 2) -> PolicyFn:
    def fn(generator, board, current):
        return greedy_jax.greedy_actions(generator, board, current, depth)

    return fn


def dqn_policy(net, eps: float = 0.0) -> PolicyFn:
    """Masked (eps-)greedy policy of a Q-net (a ``QNet`` on the board's
    device)."""

    @torch.no_grad()
    def fn(generator, board, current):
        mask = bc.legal_mask_planes(board, current)
        greedy = masked_argmax(net(bc.features_lm(board, current).t()), mask.t())
        if eps == 0.0:
            return greedy
        rand = bc.sample_random_lm(generator, mask)
        explore = torch.rand(greedy.shape, generator=generator, device=greedy.device) < eps
        return torch.where(explore, rand, greedy)

    return fn


def play_match(policy_a: PolicyFn, policy_b: PolicyFn, num_games: int = 512,
               max_plies: int = 100, seed: int = 0, swap_colors: bool = True,
               device=None) -> Dict[str, float]:
    """A-vs-B match, one game a lane; with ``swap_colors`` B moves first in
    half of the games.  Returns win/loss/undecided counts and the win rate
    for policy A.

    The ply loop runs on the host and stops once every game is over:
    finished games are frozen, so stopping early changes no result."""
    dev = resolve_device(device)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)

    def run(first_is_a: bool, games: int):
        state = bc.reset_planes(games, dev)
        a_player = 0 if first_is_a else 1
        for _ in range(max_plies):
            act_a = policy_a(generator, state.board, state.current)
            act_b = policy_b(generator, state.board, state.current)
            # no auto-reset: each lane is one game
            state = bc.step_planes(state, torch.where(state.current == a_player, act_a, act_b))
            if bool(state.done.all()):
                break
        a_sign = 1 if first_is_a else -1
        wins = int((state.winner == a_sign).sum())
        losses = int((state.winner == -a_sign).sum())
        return wins, losses, games - wins - losses

    if swap_colors:
        half = num_games // 2
        w1, l1, u1 = run(True, half)
        w2, l2, u2 = run(False, num_games - half)
        wins, losses, undecided = w1 + w2, l1 + l2, u1 + u2
    else:
        wins, losses, undecided = run(True, num_games)
    return {
        "games": num_games,
        "wins": wins,
        "losses": losses,
        "undecided": undecided,
        "win_rate": wins / max(wins + losses, 1),
    }
