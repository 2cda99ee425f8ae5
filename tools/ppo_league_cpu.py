"""The ppo_league recipe's defense bank and the agent's defense on the CPU.

    python tools/ppo_league_cpu.py [--threads 2] [--salts 6]

Runs the port on the CPU, in one process, in this order: the recipe's
384-game bank of both sides at depth 16 from a cleared solver table
(host seconds, rows); ``defense_audit`` of ``zoo.policy("ppo_league")``
(32 games, depth 18, seed 0) with the table the bank left; 256 games
against the depth-2 greedy; the same bank again, from the table those
left (its rows differ: the table steers the solver's ties); then the
audit against oracles of fixed salts, each from a cleared table.  Prints
one JSON line per step.  Its numbers are the CPU's, never the card's.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gobblet_rl_torch import zoo  # noqa: E402
from gobblet_rl_torch.eval import tournament  # noqa: E402
from gobblet_rl_torch.native import engine  # noqa: E402
from gobblet_rl_torch.train import defense  # noqa: E402

CPU = torch.device("cpu")


def fixed_salt_oracle(salt: int, depth: int):
    def fn(_, board, current):
        boards = board.permute(2, 0, 1).reshape(-1, 27).numpy()
        return torch.from_numpy(engine.solve_batch(boards, current.numpy().astype(np.int32),
                                                   depth, salt))
    return fn


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--threads", type=int, default=2)
    parser.add_argument("--salts", type=int, default=6)
    args = parser.parse_args()
    torch.set_num_threads(args.threads)

    engine.solve_tt_clear()
    t0 = time.perf_counter()
    bank = defense.generate_defense_bank(num_games=384, seed=1626, depth=16, sides="both",
                                         device=CPU)
    print(json.dumps({"step": "bank", "host_s": time.perf_counter() - t0,
                      "rows": len(bank["action"])}), flush=True)
    policy = zoo.policy("ppo_league", device=CPU)
    t0 = time.perf_counter()
    audit = tournament.defense_audit(policy, num_games=32, depth=18, seed=0, device=CPU)
    print(json.dumps({"step": "audit", "s": time.perf_counter() - t0, **audit}), flush=True)
    t0 = time.perf_counter()
    match = tournament.play_match(policy, tournament.greedy_policy(2), num_games=256, seed=0,
                                  device=CPU)
    print(json.dumps({"step": "vs greedy-2", "s": time.perf_counter() - t0, **match}),
          flush=True)
    again = defense.generate_defense_bank(num_games=384, seed=1626, depth=16, sides="both",
                                          device=CPU)
    print(json.dumps({"step": "bank, warm table", "rows": len(again["action"])}), flush=True)
    for salt in range(args.salts):
        engine.solve_tt_clear()
        res = tournament.defense_audit(policy, num_games=32, depth=18, device=CPU,
                                       oracle_policy=fixed_salt_oracle(salt, 18))
        print(json.dumps({"step": "audit, fixed salt", "salt": salt, **res}), flush=True)
    engine.solve_tt_clear()


if __name__ == "__main__":
    main()
