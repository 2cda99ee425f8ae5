"""Profile the DQN, PPO or AlphaZero iteration on the card: a table of
device time by operation.

Port of ``scripts/profile_dqn.py`` over ``torch.profiler``: the same
configurations, 2 warm-up iterations outside the trace and ``--iters``
inside ``utils.profiling.trace``; the Chrome trace is reduced to device
time by kernel name (kernels, memcpy and memset rows) and by class,
printed as markdown, and summarised in one JSON line.  On ``--device cpu``
the table holds the CPU ops' exclusive time instead.

    python -m gobblet_rl_torch.scripts.profile_dqn [--envs 262144] [--iters 3]
    python -m gobblet_rl_torch.scripts.profile_dqn --family ppo --envs 8192

The JAX script's ``--prng`` has no counterpart: torch has one Philox
generator.  ``module_ms_per_iter`` is the device time of one traced
iteration (the table's total over ``--iters``; ``None`` on the CPU), the
counterpart of the JAX script's compiled-module time; ``wall_s`` covers
the traced iterations only.  The trace goes to ``--logdir``, or to a
temporary directory that is removed once the table is read.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import torch

DEVICE_ROWS = ("kernel", "gpu_memcpy", "gpu_memset")


def build_dqn(envs: int, device):
    """The bench configuration of the fused DQN iteration against random,
    with the plain-headed ``QNet`` the JAX script builds."""
    from gobblet_rl_torch.models.mlp import QNet
    from gobblet_rl_torch.ops import batched_core as bc
    from gobblet_rl_torch.train import dqn, replay

    config = dqn.DQNConfig(
        num_envs=envs,
        buffer_size=max(1 << 18, envs * 16),
        batch_size=min(4096, envs),
        segment_len=16,
        update_per_collect=8,
        opponent="random",
    )
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    ts = dqn.init_train_state(config, QNet(hidden_sizes=config.hidden_sizes, device=device), gen)
    it, _ = dqn.make_train_iteration(config)
    state = {"env": bc.reset_planes(config.num_envs, device),
             "buf": replay.make_buffer(config.buffer_size, device)}

    def step():
        state["env"], state["buf"], loss = it(ts, state["env"], state["buf"], gen)
        return loss

    return step, config.num_envs * (config.segment_len + config.n_step - 1)


def build_ppo(envs: int, device):
    """The two-net self-play PPO iteration, learner role 0."""
    from gobblet_rl_torch.train import ppo as ppo_mod

    config = ppo_mod.PPOConfig(num_envs=envs, segment_len=32)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    st = ppo_mod.init_ppo(config, gen)
    it = ppo_mod.make_train_iteration(config, device=device)

    def step():
        st.env_states[0], stats = it(st.nets[0], st.nets[1], st.optimizers[0],
                                     st.env_states[0], gen, 0)
        return stats["loss"]

    return step, config.num_envs * config.segment_len


def build_az(envs: int, device):
    """The bench configuration of the AlphaZero (gumbel_lm) iteration."""
    from gobblet_rl_torch.train import alphazero as az

    config = az.AZConfig(
        search="gumbel_lm", num_sims=32, num_envs=envs, segment_len=48,
        model="conv", batch_size=min(2048, envs * 48),
    )
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    st = az.init_alphazero(config, gen)
    it = az.make_train_iteration(config)

    def step():
        return it(st, gen)["loss"]

    return step, config.num_envs * config.segment_len


BUILDERS = {"dqn": build_dqn, "ppo": build_ppo, "az": build_az}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def capture(step, logdir: str, iters: int, device) -> float:
    """2 warm-ups, then ``iters`` iterations under the profiler; the wall
    seconds of the traced iterations."""
    from gobblet_rl_torch.utils import profiling

    for _ in range(2):
        float(step())
    _sync(device)
    with profiling.trace(logdir):
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        _sync(device)
        return time.perf_counter() - t0


def _exclusive(ops: list) -> list:
    """(name, exclusive us) of each complete event on one thread: its
    duration minus its nested children's, by an interval stack."""
    ops = sorted(ops, key=lambda e: (e["ts"], -e.get("dur", 0)))
    stack, child = [], []   # stack of (end, index into child)
    for e in ops:
        ts, dur = e["ts"], e.get("dur", 0)
        while stack and ts >= stack[-1][0] - 1e-9:
            stack.pop()
        if stack:
            child[stack[-1][1]] += dur
        child.append(0.0)
        stack.append((ts + dur, len(child) - 1))
    return [(e["name"], e.get("dur", 0) - c) for e, c in zip(ops, child)]


def device_op_table(trace_json, device) -> list:
    """``[(name, total us, calls)]``, largest first, from a Chrome trace.

    On CUDA: each name's device time over the rows the profiler marks as
    kernels, memcpy and memset (every stream).  On the CPU: each CPU op's
    exclusive time, its duration minus its nested ops', per thread."""
    events = json.loads(Path(trace_json).read_text())["traceEvents"]
    spans = []
    if torch.device(device).type == "cuda":
        spans = [(e["name"], e.get("dur", 0)) for e in events
                 if e.get("ph") == "X" and e.get("cat") in DEVICE_ROWS]
    else:
        threads: dict = {}
        for e in events:
            if e.get("ph") == "X" and e.get("cat") == "cpu_op":
                threads.setdefault((e.get("pid"), e.get("tid")), []).append(e)
        for ops in threads.values():
            spans += _exclusive(ops)
    rows: dict = {}
    for name, us in spans:
        agg = rows.setdefault(name, [0.0, 0])
        agg[0] += us
        agg[1] += 1
    return sorted(((name, us, n) for name, (us, n) in rows.items()), key=lambda r: -r[1])


# (class, name fragments), first match wins; names are lower-cased
CLASSES = (
    ("rollout-kernel", ("rollout",)),
    ("rng", ("philox", "distribution", "curand", "randperm", "aten::rand", "aten::normal",
             "aten::uniform", "aten::exponential", "aten::bernoulli")),
    ("matmul", ("gemm", "nvjet", "cutlass", "cublas", "cudnn", "xmma", "convolve", "conv2d",
                "convolution", "aten::mm", "addmm", "bmm", "matmul", "linear")),
    ("sort", ("sort", "topk")),
    ("gather-scatter", ("index", "gather", "scatter")),
    ("data-movement", ("copy", "memcpy", "memset", "cat", "transpose")),
    ("reduce-fusion", ("reduce",)),
    ("fusion", ("elementwise", "vectorized")),
)


def classify(name: str) -> str:
    """The class of a kernel (or CPU op) name, in the JAX script's terms:
    cuBLAS (its nvJet kernels too), CUTLASS and cuDNN kernels are matmul;
    Philox and distribution kernels rng; copies, memcpy, cat and transpose
    data movement; sort and topk sort; index, gather and scatter
    gather-scatter; reductions reduce-fusion; elementwise and vectorized
    kernels fusion; the hand rollout kernel its own class."""
    n = name.lower()
    for cls, fragments in CLASSES:
        if any(f in n for f in fragments):
            return cls
    return "other"


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--family", default="dqn", choices=sorted(BUILDERS))
    p.add_argument("--envs", type=int, default=262144)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--logdir", default="")
    p.add_argument("--json-out", default="")
    p.add_argument("--device", type=str, default="cuda")
    return p


def main(argv=None) -> dict:
    args = get_parser().parse_args(argv)
    from gobblet_rl_torch.device import resolve_device

    device = resolve_device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {device} ({name})", file=sys.stderr, flush=True)
    step, steps_per_iter = BUILDERS[args.family](args.envs, device)
    logdir = args.logdir or tempfile.mkdtemp(prefix=f"prof_{args.family}_")
    try:
        wall = capture(step, logdir, args.iters, device)
        trace_json = max(Path(logdir).glob("trace-*.json"), key=lambda p: p.stat().st_mtime)
        print(f"captured {args.iters} iterations in {wall:.3f}s -> {trace_json}",
              file=sys.stderr, flush=True)
        table = device_op_table(trace_json, device)
    finally:
        if not args.logdir:
            shutil.rmtree(logdir, ignore_errors=True)
    total_us = sum(us for _, us, _ in table)
    print(f"total device op time {total_us / 1e3:.2f} ms over {args.iters} iterations; "
          f"{sum(n for _, _, n in table)} calls", file=sys.stderr, flush=True)

    print("\n| # | op | total ms | calls | % of device time | class |")
    print("|---|---|---|---|---|---|")
    out_rows = []
    for i, (op, us, n) in enumerate(table[: args.top], 1):
        frac = 100.0 * us / max(total_us, 1e-9)
        print(f"| {i} | `{op[:70]}` | {us / 1e3:.3f} | {n} | {frac:.1f}% | {classify(op)} |")
        out_rows.append({"op": op, "total_us": round(us, 1), "calls": n,
                         "pct": round(frac, 2), "class": classify(op)})

    by_class: dict = {}
    for op, us, _ in table:
        by_class[classify(op)] = by_class.get(classify(op), 0.0) + us
    print("\nby class:")
    for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {cls}: {us / 1e3:.2f} ms ({100 * us / max(total_us, 1e-9):.1f}%)")

    summary = {
        "family": args.family,
        "envs": args.envs,
        "iters": args.iters,
        "wall_s": round(wall, 3),
        "device_total_ms": round(total_us / 1e3, 3),
        "device_busy_frac_of_wall": round(total_us / 1e6 / wall, 4),
        "module_ms_per_iter": (round(total_us / 1e3 / args.iters, 3)
                               if device.type == "cuda" else None),
        "env_steps_per_sec": round(args.iters * steps_per_iter / wall, 1),
        "by_class_ms": {k: round(v / 1e3, 3) for k, v in by_class.items()},
        "top": out_rows,
    }
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(summary, f, indent=2)
    print("\n" + json.dumps({k: v for k, v in summary.items() if k != "top"}))
    return summary


if __name__ == "__main__":
    main()
