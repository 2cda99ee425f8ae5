"""Reduce ``torch.profiler``'s in-memory events to the device's busy time,
the operations that took most of it and the longest idle gaps.

No trace file is written: the events are read where the profiler leaves
them.  A gap is named by what the host was doing when it began: the
innermost benchmark span (``bench.*``, opened by the drivers around the
program's phases) and the innermost other host operation then running.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch

from benchmark.harness.common import short_name, sync

SPAN_PREFIX = "bench."


def profiled(fn, device: torch.device) -> dict:
    """Run ``fn()`` under the profiler (host and device activity) and
    reduce its events; ``window_s`` is the host's clock around the call,
    synchronised at both ends."""
    from torch.profiler import ProfilerActivity, profile

    sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync(device)
        window_s = time.perf_counter() - t0
    return reduce(prof.events(), window_s)


def _union(intervals):
    """Merged, sorted ``(start, end)`` intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _innermost(host, t, prefix_wanted: bool):
    best = None
    for s, e, name in host:
        if s <= t < e and name.startswith(SPAN_PREFIX) == prefix_wanted:
            if best is None or e - s < best[1] - best[0]:
                best = (s, e, name)
    return best[2] if best else None


def reduce(events, window_s: float, top: int = 10) -> dict:
    """``busy_s``, ``window_s``, ``device_ops`` and ``idle_gaps`` from the
    profiler's events (times in microseconds)."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in events:
        item = (e.time_range.start, e.time_range.end, e.name)
        if e.device_type != cuda:
            host.append(item)
        elif not (getattr(e, "is_user_annotation", False) or e.name.startswith(SPAN_PREFIX)):
            # the device's copy of a host span covers its kernels and is no work
            dev.append(item)
    by_name = defaultdict(float)
    for s, e, name in dev:
        by_name[name] += (e - s) * 1e-6
    merged = _union((s, e) for s, e, _ in dev)
    busy_s = sum(e - s for s, e in merged) * 1e-6
    gaps = sorted(((b[0] - a[1], a[1]) for a, b in zip(merged, merged[1:])), reverse=True)[:top]
    idle = []
    for length, at in gaps:
        span = _innermost(host, at, True) or "outside spans"
        op = _innermost(host, at, False) or "no host op"
        idle.append([f"{span[len(SPAN_PREFIX):] if span.startswith(SPAN_PREFIX) else span}: {op}",
                     length * 1e-6])
    ops = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:top]
    return {
        "busy_s": busy_s,
        "window_s": window_s,
        "device_events": len(dev),
        "device_ops": [[short_name(name), s] for name, s in ops],
        "idle_gaps": idle,
    }


class PhaseSpans:
    """Host spans around the program's phases, opened and closed from a
    trainer's ``mark`` hook: ``begin(first)`` opens the first phase and
    ``mark(name)`` closes the running one and opens the next of ``order``."""

    def __init__(self, prefix: str, order: list):
        self.prefix, self.order = prefix, order
        self.span = None
        self.next = 0

    def _open(self, name):
        self.span = torch.profiler.record_function(f"{SPAN_PREFIX}{self.prefix}.{name}")
        self.span.__enter__()

    def begin(self):
        self.next = 0
        self._open(self.order[0])

    def mark(self, phase):
        self.span.__exit__(None, None, None)
        self.span = None
        self.next = self.order.index(phase) + 1
        if self.next < len(self.order):
            self._open(self.order[self.next])
