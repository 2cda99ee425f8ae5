"""The benchmark of ``gobblet_rl_torch`` on one NVIDIA card.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Everything is found by name:
``BENCHMARK.json`` names the cell; ``benchmark/workloads/<cell>.json``
its configuration, driver, traffic and limits;
``benchmark/configs/<config>.json`` and ``benchmark/flops/<config>.py``
the configuration; ``benchmark/drivers/<driver>.py`` the loop that runs
it; ``benchmark/metrics/<metric>.py`` the reader of each metric.

A run sets up from the seed, measures whole units of work for
``--seconds``, then judges what the timed path produced against the plain
reference in ``benchmark/reference/``.  ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics (the device's busy
time from ``torch.profiler``'s events).  The last line of standard output
is one JSON object; the numbers compared, each beside its limit, end
standard error and the result line.  Without a CUDA card (or with fewer
cards than the cell asks for) it prints no result and exits with 2; if
JAX or the JAX package was loaded, with 3.
"""

import time

_STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gobblet_rl_tpu")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_dirs() -> None:
    """Build and kernel caches of the program at fixed paths inside the
    checkout, so that only a checkout's first run builds."""
    cache = ROOT / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def loaded_forbidden() -> list:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def read_metrics(spec: dict, kind: str, cell: str, data: dict, common) -> dict:
    """The cell's metrics of ``kind`` as their readers find them; an
    end-to-end metric the cell must report and cannot is an error."""
    out = {}
    for m in spec[kind]:
        if "workloads" in m and cell not in m["workloads"]:
            continue
        reader = common.load_module(BENCH / "metrics" / f"{m['name']}.py",
                                    f"bench_metric_{m['name'].replace('.', '_')}")
        value = reader.read(data)
        if value is None:
            if kind == "end_to_end":
                raise RuntimeError(f"the cell {cell} has no reading of {m['name']}")
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def main(argv=None, device=None) -> int:
    """Run one cell; ``device`` (for the harness's own tests) skips the look
    for a card and runs there instead."""
    args = parse(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    cache_dirs()
    import torch

    # one host thread: the runs of a cell share the machine's cores
    torch.set_num_threads(1)

    from benchmark.harness import common

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        common.log(f"no cell {args.workload!r} in BENCHMARK.json; cells: {sorted(cells)}")
        return 2
    cell = cells[args.workload]
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            common.log(f"the cell {args.workload} needs {cell['chips']} CUDA card(s); "
                       f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        device = torch.device("cuda", 0)
    workload = json.loads((BENCH / "workloads" / f"{args.workload}.json").read_text())
    config_name = workload["config"]
    flops_path = BENCH / "flops" / f"{config_name}.py"
    ctx = common.Context(
        workload=workload,
        config=json.loads((BENCH / "configs" / f"{config_name}.json").read_text()),
        flops=common.load_module(flops_path, f"bench_flops_{config_name}")
        if flops_path.exists() else None,
        seed=args.seed, seconds=args.seconds, trace=bool(args.trace), device=torch.device(device),
        started=_STARTED - common.process_age_s(),
    )
    driver = common.load_module(BENCH / "drivers" / f"{workload['driver']}.py",
                                f"bench_driver_{workload['driver']}")
    common.setup_mark(ctx, "harness ready")
    data = driver.run(ctx)

    kind = "per_layer" if args.trace else "end_to_end"
    metrics = read_metrics(spec, kind, args.workload, data, common)
    dev_entry = common.device_info(ctx.device) if ctx.device.type == "cuda" else \
        {"platform": "cpu", "kind": "cpu", "count": 1}
    dev_entry["memory_peak_bytes"] = int(data["memory_peak_bytes"])
    line = {"correct": None, "attempted": int(data["attempted"]), "failed": int(data["failed"]),
            "metrics": metrics, "device": dev_entry}
    if args.trace:
        tr = data["trace"]
        dev_entry["busy_s"], dev_entry["window_s"] = tr["busy_s"], tr["window_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    checks = data["checks"]
    line["correct"] = all(limit is not None and value <= limit for _, value, limit in checks)
    line["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}

    found = loaded_forbidden()
    if found:
        common.log(f"the run loaded modules it must not: {found}")
        return 3
    if ctx.device.type == "cuda":
        common.log(f"card and power limit: {common.power_limit()}")
    common.log(f"window: {data['window_s']:.3f} s, attempted {line['attempted']}, "
               f"failed {line['failed']}")
    for name, value, limit in checks:
        common.log(f"check {name}: {value!r} (limit {limit!r})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
