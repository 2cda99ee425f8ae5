"""Readings that the limits of ``correct`` are set from, one JSON line a seed.

    python benchmark/calibrate.py --workload <cell> --seeds <n> [<n> ...]

For each seed it sets the cell up as a run does and reads, without a
measured window:

* ``program``: the numbers a run compares, for the program's own output;
* ``control``: the same numbers for the reference put in the program's
  place one precision down (every matmul operand through float8 e4m3,
  the step below the configuration's bfloat16);
* training cells also ``half_batch``: the reference that takes the loss
  over the first half of each minibatch only, against the whole.

A state left unchanged reads 1 on ``change_gap`` by its definition and
needs no run.  Needs a CUDA card, like a run.
"""

import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def training(ctx, driver) -> dict:
    from benchmark.harness import common
    from benchmark.reference import qnet as ref_qnet

    s = driver.setup(ctx)
    cfg, weights, probe = s["cfg"], s["weights"], s["probe"]
    for key in ("ts", "iteration", "env", "buf"):
        del s[key]
    common.empty_cache(ctx.device)
    losses = [float(x) for x in probe.losses]
    rcfg = driver.reference_config(ctx, cfg)
    with ref_qnet.exact_float32():
        batches = driver.minibatches(cfg, probe)
        ref = ref_qnet.train(weights, batches, rcfg)
        yard = ref_qnet.first_gradient(weights, batches[0][0], rcfg, quant=ref_qnet.bf16)
        program = driver.gaps(losses, probe.grad0, s["params_after"], ref, weights, yard)
        program["bad_transitions"] = sum(driver.transition_faults(cfg, probe, s["start"]).values())
        c_losses, c_grad0, c_params = ref_qnet.train(weights, batches, rcfg, quant=ref_qnet.fp8_e4m3)
        control = driver.gaps(c_losses, c_grad0, c_params, ref, weights, yard)
        h_losses, h_grad0, h_params = ref_qnet.train(weights, batches, rcfg,
                                                     rows=slice(0, cfg.batch_size // 2))
        half = driver.gaps(h_losses, h_grad0, h_params, ref, weights, yard)
    return {"program": program, "control": control, "half_batch": half}


def play(ctx, driver) -> dict:
    import numpy as np
    import torch

    from benchmark.reference import qnet as ref_qnet

    s = driver.setup(ctx)
    played = np.array([s["agent"].compute_action(o, m) for o, m in zip(s["obs"], s["mask"])])
    q = driver.reference_q(s["weights"], s["board"], s["current"])
    gap, illegal = driver.widest_gap(q, torch.from_numpy(played).to(q.device))
    qc = driver.reference_q(s["weights"], s["board"], s["current"], quant=ref_qnet.fp8_e4m3)
    cgap, _ = driver.widest_gap(q, qc.argmax(1))
    return {"program": {"q_gap": gap, "illegal_moves": illegal}, "control": {"q_gap": cgap}}


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness import common

    if not torch.cuda.is_available():
        common.log("calibrate needs a CUDA card")
        return 2
    workload = json.loads((BENCH / "workloads" / f"{args.workload}.json").read_text())
    config = json.loads((BENCH / "configs" / f"{workload['config']}.json").read_text())
    driver = common.load_module(BENCH / "drivers" / f"{workload['driver']}.py",
                                f"bench_driver_{workload['driver']}")
    read = play if workload["driver"] == "host_play" else training
    common.log(f"card and power limit: {common.power_limit()}")
    for seed in args.seeds:
        ctx = common.Context(workload=workload, config=config, flops=None, seed=seed, seconds=0,
                             trace=False, device=torch.device("cuda", 0),
                             started=time.perf_counter())
        print(json.dumps({"workload": args.workload, "seed": seed, **read(ctx, driver)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
