"""Weak-scaling harness: fused-rollout env-steps/s against the number of
ranks.

Port of the repository's ``bench_scaling.py``.  It holds the env batch
of a rank constant and grows the ranks (1, 2, 4, 8, up to
``GOBBLET_SCALING_MAX_DEVICES`` and the ranks available), so ideal scaling
is a flat rate a rank.  Each size is a fresh process group of spawned
ranks (``parallel/multihost.py::spawn_ranks``); each rank takes its block
of the global env state (``parallel/mesh.py::shard_env_state``) and runs
the rollout kernel (``kernels/rollout.py::rollout_random_fused``) on it.
A size's rate is its env-steps over the slowest rank's time between two
barriers, the median of ``GOBBLET_SCALING_REPEATS`` after one warm-up.

By default a rank is a CUDA card over NCCL, as many as the host has; on
one card only size 1 runs.  ``GOBBLET_SCALING_FORCE_CPU=1`` runs gloo
ranks on the CPU, where the kernel's plain version runs and the ranks
share the host's cores: that checks the sharded data path, not scaling.

    python -m gobblet_rl_torch.scripts.bench_scaling
    GOBBLET_SCALING_FORCE_CPU=1 GOBBLET_SCALING_MAX_DEVICES=2 \\
        python -m gobblet_rl_torch.scripts.bench_scaling

Prints one JSON line a size and a final summary line:
    {"metric": "weak_scaling_efficiency", "value": ..., ...}
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import torch

MAX_DEVICES = int(os.environ.get("GOBBLET_SCALING_MAX_DEVICES", "8"))
PER_DEVICE_BATCH = int(os.environ.get("GOBBLET_SCALING_BATCH", "16384"))
STEPS = int(os.environ.get("GOBBLET_SCALING_STEPS", "32"))
REPEATS = int(os.environ.get("GOBBLET_SCALING_REPEATS", "3"))
FORCE_CPU = os.environ.get("GOBBLET_SCALING_FORCE_CPU", "0") == "1"


def scaling_rank(rank, world, dev, per_rank_batch: int, steps: int, repeats: int) -> dict:
    """One rank: its block of a ``world * per_rank_batch`` env state, one
    warm-up call, then ``repeats`` calls each timed between two barriers;
    every rank returns the slowest rank's seconds of each call and its own
    kernel launches."""
    import torch.distributed as dist

    from gobblet_rl_torch.kernels import rollout as R
    from gobblet_rl_torch.ops import batched_core as bc
    from gobblet_rl_torch.parallel import mesh as mesh_mod

    mesh = mesh_mod.make_mesh(device=dev)
    state = mesh_mod.shard_env_state(bc.reset_planes(world * per_rank_batch, dev), mesh)
    board, current = state.board, state.current
    seed = rank * mesh_mod.RANK_SEED_STRIDE
    board, current, _ = R.rollout_random_fused(board, current, steps, seed=seed)
    seconds = []
    for i in range(repeats):
        dist.barrier()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        board, current, _ = R.rollout_random_fused(board, current, steps, seed=seed + 1 + i)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dist.barrier()
        dt = torch.tensor([time.perf_counter() - t0], dtype=torch.float64, device=dev)
        dist.all_reduce(dt, op=dist.ReduceOp.MAX)
        seconds.append(float(dt))
    return {"seconds": seconds, "launches": R.rollout_random_fused.launches}


def main() -> None:
    from gobblet_rl_torch.device import resolve_device
    from gobblet_rl_torch.parallel.multihost import spawn_ranks
    # the rank body by its module's name, whatever ran this one as __main__
    from gobblet_rl_torch.scripts import bench_scaling

    dev = torch.device("cpu") if FORCE_CPU else resolve_device(None)
    n_avail = MAX_DEVICES if FORCE_CPU else torch.cuda.device_count()
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= min(MAX_DEVICES, n_avail)]
    print(f"# ranks available: {n_avail} ({dev.type})", file=sys.stderr)
    if FORCE_CPU:
        print("# NOTE: CPU ranks share the host's cores; sub-linear 'scaling' here is "
              "expected: this checks the sharded data path, real efficiency needs cards.",
              file=sys.stderr)
    elif n_avail == 1:
        print("# NOTE: one card: only size 1 runs, so the efficiency is 1 by definition.",
              file=sys.stderr)

    rates = {}
    for n in sizes:
        ranks = spawn_ranks(bench_scaling.scaling_rank, n, (PER_DEVICE_BATCH, STEPS, REPEATS),
                            device=dev.type, timeout=600)
        batch = PER_DEVICE_BATCH * n
        rate = statistics.median(batch * STEPS / s for s in ranks[0]["seconds"])
        rates[n] = rate
        print(f"# {n} ranks: kernel launches {[r['launches'] for r in ranks]}, slowest "
              f"rank's seconds {ranks[0]['seconds']}", file=sys.stderr)
        print(json.dumps({
            "metric": "weak_scaling_env_steps_per_sec",
            "devices": n,
            "batch": batch,
            "value": round(rate, 1),
            "per_device": round(rate / n, 1),
            "unit": "steps/s",
        }), flush=True)

    base = rates[sizes[0]]
    largest = sizes[-1]
    efficiency = rates[largest] / (base * largest)
    print(json.dumps({
        "metric": "weak_scaling_efficiency",
        "value": round(efficiency, 3),
        "unit": f"fraction of linear at {largest} devices",
        "devices": largest,
        "per_device_batch": PER_DEVICE_BATCH,
    }))


if __name__ == "__main__":
    main()
