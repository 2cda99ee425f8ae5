"""What every driver shares: the run's context, the weights made from the
seed, the device's description and the helpers around the clock."""

from __future__ import annotations

import dataclasses
import importlib.util
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

# Dense bf16 tensor-core peaks, keyed by the name torch gives the card
# (NVIDIA's H100 SXM data sheet, without sparsity, at its 700 W limit).
PEAK_BF16_FLOPS = {"NVIDIA H100 80GB HBM3": 989e12}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Context:
    """One run: the cell's entries and files, the command line's values,
    and the clock of the process's start."""

    workload: dict          # benchmark/workloads/<cell>.json
    config: dict            # benchmark/configs/<config>.json
    flops: object           # benchmark/flops/<config>.py, loaded
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    started: float          # perf_counter() at the process's start


def setup_mark(ctx, what: str) -> None:
    """Log the host seconds from the process's start to ``what``."""
    log(f"set-up: {what} at {time.perf_counter() - ctx.started:.3f} s")


def load_module(path: Path, name: str):
    """Import the file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def process_age_s() -> float:
    """Seconds since this process started, from the kernel's record where
    there is one (Linux), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 0.0
    return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def lecun_weights(seed: int, shapes: dict, device: torch.device) -> dict:
    """float32 weights for ``shapes`` (name -> shape): every matrix
    ``[out, in]`` drawn in one call from a generator on ``device`` seeded
    with ``seed`` (a normal truncated at two standard deviations, variance
    1/in, flax's default), every bias zero."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    mats = {k: s for k, s in shapes.items() if len(s) == 2}
    total = sum(math.prod(s) for s in mats.values())
    lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, (1 + math.erf(2 / math.sqrt(2))) / 2
    flat = torch.rand(total, generator=gen, device=device) * (2 * hi - 2 * lo) + (2 * lo - 1)
    flat = torch.erfinv(flat) * math.sqrt(2.0) / 0.87962566103423978
    out, at = {}, 0
    for name, shape in shapes.items():
        if len(shape) == 2:
            n = math.prod(shape)
            out[name] = (flat[at:at + n] / math.sqrt(shape[1])).view(shape).clone()
            at += n
        else:
            out[name] = torch.zeros(shape, dtype=torch.float32, device=device)
    return out


def qnet_shapes(hidden_sizes, dueling: bool, num_actions: int = 54, inputs: int = 117) -> dict:
    """Leaf name -> shape of the recipe's Q-net, in its state dict's order."""
    widths = [inputs, *hidden_sizes]
    shapes = {}
    for i, (a, b) in enumerate(zip(widths, widths[1:])):
        shapes[f"hidden.{i}.weight"], shapes[f"hidden.{i}.bias"] = (b, a), (b,)
    shapes["head.weight"], shapes["head.bias"] = (num_actions, widths[-1]), (num_actions,)
    if dueling:
        shapes["value.weight"], shapes["value.bias"] = (1, widths[-1]), (1,)
    return shapes


def device_info(device: torch.device) -> dict:
    """The result's ``device`` entry (without the peak, read later)."""
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"


def short_name(name: str, width: int = 160) -> str:
    """A kernel's name cut to ``width`` characters."""
    return name if len(name) <= width else name[:width - 3] + "..."


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between
    closest ranks."""
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


class Stamp:
    """A point on the device's stream (a CUDA event), or on the host's
    clock after a synchronise where there is no card."""

    def __init__(self, device: torch.device):
        if device.type == "cuda":
            self.event = torch.cuda.Event(enable_timing=True)
            self.event.record()
        else:
            self.event, self.t = None, time.perf_counter()

    def ms_to(self, later: "Stamp") -> float:
        if self.event is not None:
            return self.event.elapsed_time(later.event)
        return (later.t - self.t) * 1e3


def peak_flops(device: torch.device):
    """The card's dense bf16 peak, or None where it has no entry."""
    if device.type != "cuda":
        return None
    return PEAK_BF16_FLOPS.get(torch.cuda.get_device_name(device))


def memory_peak(device: torch.device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def empty_cache(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.empty_cache()
