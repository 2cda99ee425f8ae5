"""Structural audit of a data-parallel step: its collectives and its layout.

Counterpart of ``gobblet_rl_tpu/parallel/hlo_audit.py``.  A throughput
floor only catches catastrophes; a layout regression (a replay shard
silently replicated, env data crossing ranks) is a structural fact of the
step itself.  JAX reads it from the compiled HLO; torch compiles nothing,
so the audit reads what ran:

* :func:`collective_census` runs one call under ``torch.profiler`` and
  lists every collective the process-group backend recorded (``gloo:*``,
  ``nccl:*``) with its payload bytes.  A data-parallel step should hold
  only the parameter-sized gradient ``all_reduce`` (plus scalar stats);
  an ``all_gather`` or ``all_to_all`` means batch data crossed ranks.  The
  events come from the profiler, not from a list the port keeps, so a
  collective added anywhere shows up.
* :func:`local_leaves` maps a state's leaves to their PER-RANK shapes, and
  :func:`is_partitioned` says whether a leaf holds exactly its block of
  the global array (not the whole of it on every rank).
"""

from __future__ import annotations

import json
import os
import tempfile

import torch

# the C++ element types the profiler records for a collective's input
DTYPE_BYTES = {
    "bool": 1, "signed char": 1, "unsigned char": 1, "short": 2, "c10::Half": 2,
    "c10::BFloat16": 2, "int": 4, "unsigned int": 4, "float": 4, "long int": 8,
    "long": 8, "long long": 8, "unsigned long": 8, "double": 8,
}
BACKENDS = ("gloo:", "nccl:")


def _event_bytes(shapes, dtypes) -> int:
    total = 0
    for shape, dtype in zip(shapes, dtypes):
        if dtype not in DTYPE_BYTES:
            raise ValueError(f"unknown element type {dtype!r} of a collective's input")
        total += DTYPE_BYTES[dtype] * int(torch.Size(shape).numel())
    return total


def collective_census(fn, *args, **kwargs):
    """``(fn's result, [{op, bytes}, ...])``: every collective that one call
    of ``fn`` issued on this rank, in order, with the bytes of its inputs,
    read from the profiler's trace (its ``Input Dims`` and ``Input type``
    of each ``gloo:*``/``nccl:*`` event)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        out = fn(*args, **kwargs)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    census = []
    for e in sorted((e for e in events if e.get("name", "").startswith(BACKENDS)),
                    key=lambda e: e["ts"]):
        args = e.get("args", {})
        if "Input type" not in args:
            raise ValueError(f"the profiler recorded no input types for {e['name']}")
        census.append({"op": e["name"].split(":", 1)[1],
                       "bytes": _event_bytes(args["Input Dims"], args["Input type"])})
    return out, census


def local_leaves(tree, prefix: str = "") -> dict[str, tuple]:
    """Per-rank shapes of every tensor leaf of a named tuple, dict or
    dataclass-free nest of them: ``{"board": (3, 9, 16), ...}``."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tuple(tree.shape)}
    if hasattr(tree, "_asdict"):
        items = tree._asdict().items()
    elif isinstance(tree, dict):
        items = tree.items()
    else:
        return {}
    out = {}
    for k, v in items:
        out.update(local_leaves(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def is_partitioned(local_shape: tuple, global_shape: tuple, n: int) -> bool:
    """True when a rank's leaf is its 1/n block of the global array along
    exactly one dim, and whole along the others: split over ``n`` ranks,
    not replicated on each."""
    if n < 2 or len(local_shape) != len(global_shape):
        return False
    split = [d for d, (lo, gl) in enumerate(zip(local_shape, global_shape)) if lo != gl]
    return len(split) == 1 and global_shape[split[0]] == n * local_shape[split[0]]
