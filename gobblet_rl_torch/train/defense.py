"""Solver-supervised defense distillation: the defense bank.

Port of ``gobblet_rl_tpu/train/defense.py``.  :func:`generate_defense_bank`
plays batched games of the exact solver's fastest attack (player 0, the
native ``solve_batch``) against a per-game mix of defenders (random,
greedy-1, greedy-2 and the solver itself), and records at every live
position of the defender the solver's mate-maximizing move (and, with
``sides="both"``, at every live position of the attacker its fastest
attack).  The PPO and DQN trainers add a behaviour-cloning term over the
bank to their losses (``defense_bc_weight``).

The games run on the lane-major engine on the device; the solver runs on
the host, one batch call a ply.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from gobblet_rl_torch.device import resolve_device
from gobblet_rl_torch.native import engine
from gobblet_rl_torch.ops import batched_core as bc
from gobblet_rl_torch.policies import greedy_jax

_INT32_MAX = np.iinfo(np.int32).max


def generate_defense_bank(num_games: int = 256, seed: int = 0, depth: int = 16,
                          max_plies: int = 40, sides: str = "defense", device=None,
                          draws: Callable | None = None) -> dict:
    """Play ``num_games`` oracle-attack games and label every live
    defensive position with the solver's mate-maximizing move (``sides=
    "both"``: every live attacking position with its fastest attack too).

    Returns numpy ``{"obs": int8[N, 117], "mask": bool[N, 54], "action":
    int32[N], "board": int8[N, 27]}``, one row per distinct (side, board),
    in the order first seen.

    The defender of each game comes from ``np.random.default_rng(seed)``,
    as in the JAX package.  The per-ply draws come from a generator on
    ``device`` seeded with ``seed``, or from ``draws(ply) -> (salt,
    random, greedy1, greedy2)``: the solver's salt and the float32 [54, B]
    Gumbel fields of the random and greedy defenders (read on the
    defender's plies only)."""
    if sides not in ("defense", "both"):
        raise ValueError(f"sides must be 'defense' or 'both', not {sides!r}")
    dev = resolve_device(device)
    engine.load()
    generator = None
    if draws is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)

        def draws(ply):
            salt = int(torch.randint(0, _INT32_MAX, (), generator=generator, device=dev))
            return (salt, *(bc.gumbel_field(generator, (54, num_games), dev) for _ in range(3)))

    defender = np.random.default_rng(seed).integers(0, 4, size=num_games)
    state = bc.reset_planes(num_games, dev)
    seen: dict[tuple, tuple] = {}
    for ply in range(max_plies):
        done = state.done.cpu().numpy()
        if done.all():
            break
        boards27 = state.board.permute(2, 0, 1).reshape(num_games, 27).cpu().numpy()
        mover = int(state.current.cpu().numpy()[~done][0])
        salt, g_rand, g_1, g_2 = draws(ply)
        # the attacker's fastest win, or the solver's optimal defense
        labels = engine.solve_batch(boards27, np.full(num_games, mover, np.int32), depth, salt)
        if mover == 1 or sides == "both":
            mask = bc.legal_mask_planes(state.board, state.current)
            obs = bc.features_lm(state.board, state.current).cpu().numpy()
            mask_np = mask.cpu().numpy()
            for g in np.flatnonzero(~done):
                key = (mover, boards27[g].tobytes())
                if key not in seen:
                    seen[key] = (obs[:, g], mask_np[:, g], int(labels[g]), boards27[g])
        actions = labels
        if mover == 1:
            # the move actually played: each game's assigned defender
            a_rand = bc.sample_random_lm(None, mask, g_rand.to(dev))
            a_g1 = greedy_jax.greedy_actions(None, state.board, state.current, 1, gumbel=g_1.to(dev))
            a_g2 = greedy_jax.greedy_actions(None, state.board, state.current, 2, gumbel=g_2.to(dev))
            actions = np.choose(defender, [a_rand.cpu().numpy(), a_g1.cpu().numpy(),
                                           a_g2.cpu().numpy(), labels])
        state = bc.step_planes(state, torch.as_tensor(actions, dtype=torch.int32, device=dev))

    if not seen:
        raise RuntimeError("the defense bank came out empty")
    rows = list(seen.values())
    return {
        "obs": np.stack([r[0] for r in rows]).astype(np.int8),
        "mask": np.stack([r[1] for r in rows]).astype(bool),
        "action": np.asarray([r[2] for r in rows], np.int32),
        "board": np.stack([r[3] for r in rows]).astype(np.int8),
    }


def bank_tensors(bank: dict, device) -> dict:
    """The bank's ``obs``, ``mask`` and ``action`` as tensors on ``device``,
    the form the trainers' loss terms read."""
    return {k: torch.as_tensor(bank[k], device=device) for k in ("obs", "mask", "action")}


def bank_loss(logits: torch.Tensor, bank: dict) -> torch.Tensor:
    """Masked cross-entropy of the net's ``logits`` (or Q-values) over the
    bank's rows to the solver's labels; illegal actions are filled with
    -1e9, as in both JAX trainers."""
    logp = torch.log_softmax(torch.where(bank["mask"], logits, -1e9), dim=-1)
    return -logp.gather(-1, bank["action"].long()[:, None]).mean()
