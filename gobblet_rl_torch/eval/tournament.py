"""Batched matches between policies over the lane-major engine.

Port of ``gobblet_rl_tpu/eval/tournament.py``: the random, greedy, DQN
and PPO policies, the native alpha-beta expert and exact solver as
policies, :func:`play_match`, :func:`defense_audit` and
:func:`round_robin`.  A policy is a function ``(generator, board
int8[3, 9, B], current int32[B]) -> int32[B]``.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from gobblet_rl_torch.device import resolve_device
from gobblet_rl_torch.models import actor_critic as ac
from gobblet_rl_torch.models.mlp import masked_argmax
from gobblet_rl_torch.native import engine
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


def ppo_policy(net, sample: bool = False) -> PolicyFn:
    """Masked actor policy of an actor-critic net: the masked argmax, or a
    draw from the masked softmax with ``sample``."""

    @torch.no_grad()
    def fn(generator, board, current):
        mask = bc.legal_mask_planes(board, current).t()
        logits, _ = net(bc.features_lm(board, current).t())
        if sample:
            return ac.sample_masked(generator, logits, mask)[0]
        return ac.masked_logits(logits, mask).argmax(dim=-1).to(torch.int32)

    return fn


def _native_batch_policy(batch_fn) -> PolicyFn:
    """Lift a native batch searcher ``(boards int8[n, 27], players int32[n],
    salt) -> int32[n]`` into a policy: the positions cross to the host once
    a ply and the actions come back to the board's device.  The salt is
    drawn from the policy's generator."""

    def fn(generator, board, current):
        salt = int(torch.randint(0, np.iinfo(np.int32).max, (), generator=generator,
                                 device=generator.device))
        boards = board.permute(2, 0, 1).reshape(-1, 27).cpu().numpy()
        actions = batch_fn(boards, current.cpu().numpy().astype(np.int32), salt)
        return torch.from_numpy(actions).to(board.device)

    return fn


def alphabeta_policy(depth: int = 6) -> PolicyFn:
    """The native alpha-beta expert (``csrc/gobblet.cpp``) as a policy."""
    engine.load()
    return _native_batch_policy(
        lambda boards, players, salt: engine.alphabeta_batch(boards, players, depth, salt))


def solver_policy(depth: int = 15) -> PolicyFn:
    """Perfect play from the native exact solver: at ``depth`` >= 13 it
    converts every won position it is handed (the opening is a proven
    first-player win in 13 plies); the salt varies only the choice among
    equally fast proven wins."""
    engine.load()
    return _native_batch_policy(
        lambda boards, players, salt: engine.solve_batch(boards, players, depth, salt))


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


def defense_audit(policy: PolicyFn, num_games: int = 32, seed: int = 0, depth: int = 18,
                  max_plies: int = 60, solve_fn=None, oracle_policy=None,
                  device=None) -> Dict[str, float]:
    """Defense quality against the perfect oracle: ``policy`` plays second
    against the exact solver's fastest attack, and every defensive move is
    graded with the solver's mate distances.  From a position lost in ``d``
    plies, optimal defense reaches one lost in exactly ``d - 1``; a move
    landing at ``d' < d - 1`` shortened its own mate and is a mistake.

    Returns, over ``num_games`` games: ``mean_plies_survived`` (the oracle
    attacks fastest, so game length is the defense metric), its min and
    max, ``mean_first_mistake_ply`` (1-based, over games with a mistake),
    ``clean_game_frac`` (graded games without a mistake),
    ``ungraded_games``, ``mistakes_per_game`` and ``unproven_positions``.

    ``solve_fn(board27, player) -> (proven, mate_in)`` and
    ``oracle_policy`` are injectable; the defaults are the native exact
    solver at ``depth`` and :func:`solver_policy`.  Both policies draw
    from one generator on ``device`` seeded with ``seed``."""
    if solve_fn is None:
        engine.load()

        def solve_fn(board27, player):
            res = engine.solve(board27, player=player, max_depth=depth)
            return res["proven"], res["mate_in"]

    oracle = oracle_policy if oracle_policy is not None else solver_policy(depth=depth)
    dev = resolve_device(device)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    state = bc.reset_planes(num_games, dev)
    first_mistake = np.full(num_games, -1, np.int32)
    mistakes = np.zeros(num_games, np.int32)
    unproven = 0
    ungraded = np.zeros(num_games, bool)  # the game holds an unproven position

    def boards27(state):
        return state.board.permute(2, 0, 1).reshape(num_games, 27).cpu().numpy()

    for ply in range(max_plies):
        done_before = state.done.cpu().numpy()
        if done_before.all():
            break
        mover = int(state.current.cpu().numpy()[~done_before][0])
        if mover == 0:
            state = bc.step_planes(state, oracle(generator, state.board, state.current))
            continue
        before = boards27(state)
        d_before = np.full(num_games, -1, np.int32)
        for g in np.flatnonzero(~done_before):
            proven, mate = solve_fn(before[g], 1)
            if proven and mate is not None:
                d_before[g] = mate
            else:  # the depth is too shallow to prove it
                unproven += 1
                ungraded[g] = True
        state = bc.step_planes(state, policy(generator, state.board, state.current))
        done_now = state.done.cpu().numpy()
        after = boards27(state)
        for g in np.flatnonzero(~done_before):
            if d_before[g] < 0:
                continue
            if done_now[g]:
                d_after = 0  # the move lost on the spot
            else:
                proven, mate = solve_fn(after[g], 0)
                if not proven or mate is None:
                    unproven += 1
                    ungraded[g] = True
                    continue
                d_after = mate
            if d_after < d_before[g] - 1:
                mistakes[g] += 1
                if first_mistake[g] < 0:
                    first_mistake[g] = ply + 1

    # turn counts legal plies and freezes at game end: each game's length
    lengths = state.turn.cpu().numpy()
    with_mistake = first_mistake[first_mistake > 0]
    # a game is clean only if every defensive move in it was graded
    graded = ~ungraded
    clean = (first_mistake < 0) & graded
    return {
        "games": num_games,
        "mean_plies_survived": float(lengths.mean()),
        "min_plies_survived": int(lengths.min()),
        "max_plies_survived": int(lengths.max()),
        "mean_first_mistake_ply": float(with_mistake.mean()) if with_mistake.size else None,
        "clean_game_frac": float(clean.sum() / max(int(graded.sum()), 1)),
        "ungraded_games": int(ungraded.sum()),
        "mistakes_per_game": float(mistakes.mean()),
        "unproven_positions": unproven,
    }


def round_robin(policies: Dict[str, PolicyFn], num_games: int = 256, seed: int = 0,
                device=None) -> Dict[str, Dict]:
    """Every pair in ``policies``' order through :func:`play_match` (the
    same seed for each), then an Elo fit: 200 sweeps of K=8 updates on the
    400 scale over the pairs in that order, skipping pairs without a decided
    game.  Returns ``{"standings": {name: {"wins", "losses", "elo"}},
    "pairs": {"a vs b": match}}``."""
    names = list(policies)
    results: Dict[str, Dict] = {n: {"wins": 0, "losses": 0} for n in names}
    pair_results = {}
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            match = play_match(policies[a], policies[b], num_games, seed=seed, device=device)
            pair_results[(a, b)] = match
            results[a]["wins"] += match["wins"]
            results[a]["losses"] += match["losses"]
            results[b]["wins"] += match["losses"]
            results[b]["losses"] += match["wins"]

    # the fit updates the pairs in sequence, so their order is part of it
    elo = {n: 1000.0 for n in names}
    for _ in range(200):
        for (a, b), match in pair_results.items():
            total = match["wins"] + match["losses"]
            if total == 0:
                continue
            score = match["wins"] / total
            expected = 1.0 / (1.0 + 10 ** ((elo[b] - elo[a]) / 400.0))
            delta = 8.0 * (score - expected)
            elo[a] += delta
            elo[b] -= delta
    for n in names:
        results[n]["elo"] = round(elo[n], 1)
    return {"standings": results,
            "pairs": {f"{a} vs {b}": m for (a, b), m in pair_results.items()}}
