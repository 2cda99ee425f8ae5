"""Tracing and throughput helpers.

Port of ``gobblet_rl_tpu/utils/profiling.py`` over ``torch.profiler``:

* :func:`trace` captures a profile of the host and, where there is one,
  the CUDA card, and writes it into ``logdir`` as a Chrome trace (open it
  in ``chrome://tracing`` or Perfetto);
* :func:`annotate` is the program's span.  It is off, a shared object
  that does nothing, unless ``torch.profiler`` records on this thread.
  On, it names a region in the profiler's timeline and times it on the
  host's clock (less the bookkeeping of the spans inside it) and, once
  CUDA is in use, on the card's current stream by a pair of CUDA events;
* :func:`count` adds to a counter of the open root span (off likewise);
* :func:`span_table` reads the spans and counters by name (``TABLE``,
  which :func:`trace` empties when it starts);
* :class:`Throughput` is a steps/s meter that waits for the card first.

A span opened with no span open on its thread is a root (a DQN iteration,
a zoo move); every span and count inside it carries the root's number.
Spans are kept in memory and a root's CUDA events are read only once the
card has passed them, so no span waits for the card.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import torch


def enabled() -> bool:
    """Whether spans and counters record: ``torch.profiler`` is recording
    on this thread (one C call)."""
    return torch.autograd._profiler_enabled()


class _Root:
    """The spans of one root, in the order they opened, and its counters."""

    __slots__ = ("number", "spans", "counters")

    def __init__(self, number: int):
        self.number, self.spans, self.counters = number, [], {}

    def resolved(self) -> bool:
        """Whether the card has passed every event of the root."""
        return all(s.ev1 is None or s.ev1.query() for s in self.spans)


class _Span:
    """A span while tracing is on: its name, its parent span (``None`` for
    a root), its root, its host clock, its stream's events, and the host
    ns its own bookkeeping took (``own``) and that of the spans inside it
    (``hidden``), which its host time leaves out."""

    __slots__ = ("name", "parent", "root", "t0", "t1", "own", "hidden", "stream", "ev0",
                 "ev1", "_rf")

    def __init__(self, name: str):
        self.name = name
        self.hidden = 0
        self.ev0 = self.ev1 = None

    def __enter__(self):
        t = time.perf_counter_ns()
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        TABLE._open(self)
        if torch.cuda.is_initialized():
            self.stream = torch.cuda.current_stream()
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev1 = torch.cuda.Event(enable_timing=True)
            self.ev0.record(self.stream)
        self.t0 = time.perf_counter_ns()
        self.own = self.t0 - t
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.ev1 is not None:
            self.ev1.record(self.stream)
        TABLE._close(self)
        self._rf.__exit__(*exc)
        if self.parent is not None:
            self.parent.hidden += self.own + self.hidden + time.perf_counter_ns() - self.t1
        return False


class _Off:
    """The span while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class SpanTable:
    """Spans and counters by name, over the roots whose events resolved.

    A closed root waits in ``_pending`` until the card has passed its
    events; it is then folded into the totals and its spans are dropped,
    so memory grows with the names and the roots, not with the spans."""

    def __init__(self):
        self._local = threading.local()
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        """Empty the table (roots still open on a thread fold in later)."""
        with self._lock:
            self._opened = 0
            self._roots = 0
            self._pending = []
            self._spans = {}
            self._counters = {}

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _open(self, span: _Span) -> None:
        stack = self._stack()
        if stack:
            span.parent, span.root = stack[-1], stack[-1].root
        else:
            with self._lock:
                self._opened += 1
                number = self._opened
            span.parent, span.root = None, _Root(number)
        span.root.spans.append(span)
        stack.append(span)

    def _close(self, span: _Span) -> None:
        stack = self._stack()
        stack.pop()
        if not stack:
            with self._lock:
                self._pending.append(span.root)
                self._fold(wait=False)

    def _count(self, name: str, value) -> None:
        stack = self._stack()
        if stack:
            counters = stack[0].root.counters
            counters[name] = counters.get(name, 0) + value

    def _fold(self, wait: bool) -> None:
        """Fold the pending roots in order; without ``wait``, stop at the
        first one the card has not passed yet."""
        while self._pending and (wait or self._pending[0].resolved()):
            self._add(self._pending.pop(0))

    def _add(self, root: _Root) -> None:
        stream = {id(s): s.ev0.elapsed_time(s.ev1) if s.ev0 is not None else None
                  for s in root.spans}
        children = {}
        for s in root.spans:
            if s.parent is not None and stream[id(s)] is not None:
                children[id(s.parent)] = children.get(id(s.parent), 0.0) + stream[id(s)]
        host = {}
        for s in root.spans:
            e = self._spans.setdefault(s.name, {
                "calls": 0, "roots": 0, "host_ms": 0.0, "host_ms_by_root": [],
                "stream_ms": None, "stream_self_ms": None})
            e["calls"] += 1
            ms = (s.t1 - s.t0 - s.hidden) * 1e-6
            e["host_ms"] += ms
            host[s.name] = host.get(s.name, 0.0) + ms
            ms = stream[id(s)]
            if ms is not None:
                e["stream_ms"] = (e["stream_ms"] or 0.0) + ms
                e["stream_self_ms"] = (e["stream_self_ms"] or 0.0) + ms - children.get(id(s), 0.0)
        for name, ms in host.items():
            self._spans[name]["roots"] += 1
            self._spans[name]["host_ms_by_root"].append(ms)
        for name, value in root.counters.items():
            self._counters[name] = self._counters.get(name, 0.0) + float(value)
        self._roots += 1

    def read(self) -> dict:
        """``{"roots", "spans", "counters"}`` after a synchronise: the
        number of roots folded; by span name its ``calls``, the ``roots``
        it ran in, ``host_ms`` (total and ``host_ms_by_root``, in the
        roots' order; less the bookkeeping of the spans inside it) and,
        where it ran with CUDA in use, ``stream_ms`` and
        ``stream_self_ms`` (less its children's) on the stream current at
        its start, else ``None``; by counter name its total."""
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        with self._lock:
            self._fold(wait=True)
            return {"roots": self._roots,
                    "spans": {k: {**v, "host_ms_by_root": list(v["host_ms_by_root"])}
                              for k, v in self._spans.items()},
                    "counters": dict(self._counters)}


TABLE = SpanTable()


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a profile: ``with profiling.trace("prof"): ...`` writes
    ``prof/trace-<pid>-<n>.json``.  The profiler is yielded, so the caller
    can read ``key_averages()`` too; the span table is emptied first, so
    :func:`span_table` reads the spans of this capture."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    TABLE.reset()
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    n = len([f for f in os.listdir(logdir) if f.startswith(f"trace-{os.getpid()}-")])
    prof.export_chrome_trace(os.path.join(logdir, f"trace-{os.getpid()}-{n}.json"))


def annotate(name: str):
    """The program's span ``name``, a context manager: recorded only while
    :func:`enabled` (no ``record_function`` is opened otherwise)."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name)


def count(name: str, value) -> None:
    """Add ``value`` (a number, or a tensor summed on its device and read
    with the table) to the counter ``name`` of the open root span; nothing
    while tracing is off or no span is open.  A caller whose value costs work computes it
    only under :func:`enabled`."""
    if torch.autograd._profiler_enabled():
        TABLE._count(name, value)


def span_table() -> dict:
    """The spans and counters recorded so far (:meth:`SpanTable.read`)."""
    return TABLE.read()


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
