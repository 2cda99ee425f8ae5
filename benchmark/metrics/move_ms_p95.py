"""move_ms_p95: the 95th percentile of every move of the window, host ms
from the agent's call to its returned action."""

from benchmark.harness.common import percentile


def read(data):
    if not data.get("move_ms"):
        return None
    return percentile(data["move_ms"], 95)
