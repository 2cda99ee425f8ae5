"""dqn.device_busy_ms: the ms in which a kernel, copy or fill ran on the card
over one profiled steady iteration (after the window): the iteration's
device time, which the host's speed does not move."""


def read(data):
    tr = data.get("trace")
    if "iterations" not in data or not tr or not tr["device_events"]:
        return None
    return tr["busy_s"] * 1e3
