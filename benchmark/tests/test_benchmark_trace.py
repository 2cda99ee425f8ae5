"""The reduction of the profiler's events: the device's busy time is the
union of its kernels, copies and fills, and the device's copy of a host
span (a user annotation, which covers the kernels under it) is no work."""

from types import SimpleNamespace

import torch

from benchmark.harness import trace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def event(start, end, name, device, annotation=False):
    return SimpleNamespace(time_range=SimpleNamespace(start=start, end=end), name=name,
                           device_type=device, is_user_annotation=annotation)


def test_busy_time_and_gaps():
    events = [
        event(0, 1000, "bench.dqn.collect", CPU, True),
        event(0, 1000, "bench.dqn.collect", CUDA, True),     # the span's device copy
        event(10, 20, "aten::add", CPU),
        event(100, 200, "kernel_a", CUDA),
        event(150, 250, "kernel_b", CUDA),                   # overlaps kernel_a
        event(300, 310, "aten::mul", CPU),
        event(600, 700, "kernel_a", CUDA),
    ]
    out = trace.reduce(events, window_s=1e-3)
    assert abs(out["busy_s"] - 250e-6) < 1e-12
    assert out["device_events"] == 3
    assert out["device_ops"][0][0] == "kernel_a"
    assert abs(out["device_ops"][0][1] - 200e-6) < 1e-12
    # the one gap, 250 -> 600 us, began while the host ran nothing under the span
    assert len(out["idle_gaps"]) == 1
    name, length = out["idle_gaps"][0]
    assert name == "dqn.collect: no host op" and abs(length - 350e-6) < 1e-12
