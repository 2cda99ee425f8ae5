"""Tracing and throughput helpers.

Port of ``gobblet_rl_tpu/utils/profiling.py`` over ``torch.profiler``:

* :func:`trace` captures a profile of the host and, where there is one,
  the CUDA card, and writes it into ``logdir`` as a Chrome trace (open it
  in ``chrome://tracing`` or Perfetto);
* :func:`annotate` names a region in that trace;
* :class:`Throughput` is a steps/s meter that waits for the card first.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a profile: ``with profiling.trace("prof"): ...`` writes
    ``prof/trace-<pid>-<n>.json``.  The profiler is yielded, so the caller
    can read ``key_averages()`` too."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    n = len([f for f in os.listdir(logdir) if f.startswith(f"trace-{os.getpid()}-")])
    prof.export_chrome_trace(os.path.join(logdir, f"trace-{os.getpid()}-{n}.json"))


def annotate(name: str):
    """Named region in the profiler timeline."""
    return torch.profiler.record_function(name)


def _synchronize(result) -> None:
    """Wait for the card of every CUDA tensor in ``result`` (a tensor, or
    lists, tuples and dicts of them, or objects with tensor fields)."""
    devices = set()
    stack = [result]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    for device in devices:
        torch.cuda.synchronize(device)


class Throughput:
    """steps/s meter: ``t = Throughput(); ...; r = t.rate(n_steps, result)``.

    ``rate`` waits for the card that holds any tensor of ``result``, so the
    time covers the work queued on it, then returns steps per second and
    restarts the clock."""

    def __init__(self):
        self._t0 = time.perf_counter()

    def reset(self):
        self._t0 = time.perf_counter()

    def rate(self, num_steps: int, result=None) -> float:
        if result is not None:
            _synchronize(result)
        dt = time.perf_counter() - self._t0
        self._t0 = time.perf_counter()
        return num_steps / dt if dt > 0 else float("inf")
