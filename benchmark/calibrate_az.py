"""Readings that the limits of an AlphaZero cell's ``correct`` are set from,
one JSON line a seed.

    python benchmark/calibrate_az.py --workload <cell> --seeds <n> [<n> ...]

For each seed it sets the cell up as a run does (the checked iterations)
and reads, without a measured window:

* ``program``: the numbers a run compares, for the program's own output;
* ``control``: the same numbers for the reference put in the program's
  place one precision down (every convolution and matmul operand and
  result through float8 e4m3, the step below the configuration's
  bfloat16): its net against the float32 net, its search against the
  bfloat16 search, its learner against the float32 learner;
* ``faults``, each the reference with one fault planted against the
  reference without: ``backup_sign`` (the backup adds each value without
  the change of side), ``no_halving`` (the first considered set is kept
  all search long), ``half_batch`` (the loss over the first half of each
  minibatch); and, against the reference's target on the program's own
  roots, ``flatten_won`` (the program's targets flattened at the roots
  with a won child, a minority) and ``unvalued_wins`` (its root value not
  set to 1 where the root's player can win at once).  A state left unchanged
  reads 1 on ``change_gap`` by its definition and needs no run.

Needs a CUDA card, like a run.
"""

import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def readings(ctx, driver) -> dict:
    from benchmark.harness import common
    from benchmark.reference import qnet as ref_qnet

    s = driver.setup(ctx)
    cfg, weights, probe = s["cfg"], s["weights"], s["probe"]
    del s["st"], s["iteration"]
    common.empty_cache(ctx.device)
    out = {"program": {}, "control": {}, "faults": {}}
    with ref_qnet.exact_float32():
        out["program"]["bad_rows"], _ = driver.bad_rows(probe)
        out["program"]["net_gap"] = driver.net_gap(probe)
        out["control"]["net_gap"] = driver.net_gap(probe, quant=ref_qnet.fp8_e4m3)
        out["program"].update(driver.target_gaps(ctx, cfg, probe))
        out["faults"]["flatten_won"] = driver.target_gaps(ctx, cfg, probe, driver.flatten_won)
        out["faults"]["unvalued_wins"] = driver.target_gaps(ctx, cfg, probe, unvalued_wins=True)
        yard = driver.reference_search(ctx, cfg, probe, ref_qnet.bf16)
        out["program"].update(driver.search_gaps(driver.program_search(probe), yard))
        control = driver.reference_search(ctx, cfg, probe, ref_qnet.fp8_e4m3)
        out["control"].update(driver.search_gaps(control, yard))
        for name, fault in (("backup_sign", {"flip": False}), ("no_halving", {"halving": False})):
            out["faults"][name] = driver.search_gaps(
                driver.reference_search(ctx, cfg, probe, ref_qnet.bf16, **fault), yard)
        args = (ctx, cfg, weights, probe, s["params_after"])
        out["program"].update(driver.learner_gaps(*args))
        out["control"].update(driver.learner_gaps(*args, quant=ref_qnet.fp8_e4m3))
        half = slice(0, probe.iterations[0]["mb"] // 2)
        out["faults"]["half_batch"] = driver.learner_gaps(*args, rows=half)
    return out


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
        common.log("calibrate_az needs a CUDA card")
        return 2
    workload = json.loads((BENCH / "workloads" / f"{args.workload}.json").read_text())
    config = json.loads((BENCH / "configs" / f"{workload['config']}.json").read_text())
    driver = common.load_module(BENCH / "drivers" / f"{workload['driver']}.py",
                                f"bench_driver_{workload['driver']}")
    common.log(f"card and power limit: {common.power_limit()}")
    for seed in args.seeds:
        ctx = common.Context(workload=workload, config=config, flops=None, seed=seed, seconds=0,
                             trace=False, device=torch.device("cuda", 0),
                             started=time.perf_counter())
        print(json.dumps({"workload": args.workload, "seed": seed, **readings(ctx, driver)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
