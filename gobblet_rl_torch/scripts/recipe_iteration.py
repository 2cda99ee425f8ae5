"""Time one training iteration of the zoo's recipes on the card, each at its
own width, and project the recipe's training minutes from it.

    python -m gobblet_rl_torch.scripts.recipe_iteration [--device cuda]

Each entry takes its full recipe from ``make_zoo`` (its defaults: not
``--quick``, seed 1626): one warm-up iteration, then ``ITERS`` timed ones
on the host clock, each ending in a synchronise.  ``dqn_greedy`` (1,024
envs, the greedy opponent, both seats) also times one per-epoch
evaluation.  The projection is the recipe's iteration count times the
median iteration (plus, for the DQN, an evaluation an epoch); the final
strength measurement is not in it.  Prints the card's name and power
limit, then one JSON line per entry.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

from gobblet_rl_torch.device import resolve_device
from gobblet_rl_torch.scripts import make_zoo
from gobblet_rl_torch.train import alphazero, dqn, replay

ITERS = 2


def timed(fn, device) -> float:
    """Seconds of one call of ``fn``, waiting for the card."""
    t0 = time.perf_counter()
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def dqn_greedy(recipe, device) -> dict:
    config = make_zoo.dqn_config(recipe)
    gen = torch.Generator(device=device)
    gen.manual_seed(config.seed)
    ts = dqn.init_train_state(config, dqn.make_net(config, device), gen)
    it, opp_fn = dqn.make_train_iteration(config)
    box = {"env": dqn.init_env_state(config, opp_fn, ts.opponent_net, gen),
           "buf": replay.make_buffer(config.buffer_size, device)}

    def step():
        box["env"], box["buf"], _ = it(ts, box["env"], box["buf"], gen)

    evaluate = dqn.make_eval_fn(config, opp_fn)
    timed(step, device)
    iter_s = [timed(step, device) for _ in range(ITERS)]
    eval_s = timed(lambda: evaluate(ts.net, ts.opponent_net, gen), device)
    per_epoch = config.step_per_epoch * statistics.median(iter_s) + eval_s
    return {"num_envs": config.num_envs, "opponent": config.opponent,
            "learner_player": config.learner_player, "iteration_s": iter_s,
            "eval_s": eval_s, "epochs": config.epoch, "step_per_epoch": config.step_per_epoch,
            "projected_train_minutes": config.epoch * per_epoch / 60}


def alphazero_gumbel32(recipe, device) -> dict:
    config = make_zoo.alphazero_config(recipe)
    gen = torch.Generator(device=device)
    gen.manual_seed(config.seed)
    st = alphazero.init_alphazero(config, gen)
    it = alphazero.make_train_iteration(config)
    timed(lambda: it(st, gen), device)
    iter_s = [timed(lambda: it(st, gen), device) for _ in range(ITERS)]
    return {"num_envs": config.num_envs, "num_sims": config.num_sims,
            "segment_len": config.segment_len, "iteration_s": iter_s,
            "iterations": config.iterations,
            "projected_train_minutes": config.iterations * statistics.median(iter_s) / 60}


ENTRIES = {"dqn_greedy": dqn_greedy, "alphazero_gumbel32": alphazero_gumbel32}


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--device", type=str, default="cuda")
    device = resolve_device(p.parse_args(argv).device)
    recipe = make_zoo.get_parser().parse_args([])
    smi = "cpu"
    if device.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    for name, fn in ENTRIES.items():
        t0 = time.perf_counter()
        out = fn(recipe, device)
        print(json.dumps({"recipe": name, "device": smi, **out,
                          "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
