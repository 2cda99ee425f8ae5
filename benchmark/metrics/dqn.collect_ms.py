"""dqn.collect_ms: the mean ms of a window iteration's collect phase on the
device's stream, from a CUDA event recorded as the iteration is issued to
one recorded at the trainer's ``mark("collect")``."""

import statistics


def read(data):
    ms = data.get("phase_ms", {}).get("collect")
    return statistics.fmean(ms) if ms else None
