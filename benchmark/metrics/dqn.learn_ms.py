"""dqn.learn_ms: the mean ms of a window iteration's fold and insert,
sample and updates on the device's stream, between the CUDA events at
``mark("collect")`` and ``mark("updates")``."""

import statistics


def read(data):
    ms = data.get("phase_ms", {}).get("learn")
    return statistics.fmean(ms) if ms else None
