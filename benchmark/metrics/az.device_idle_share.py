"""az.device_idle_share: the share of one profiled steady AlphaZero
iteration (after the window) in which no kernel, copy or fill ran on the
card."""


def read(data):
    tr = data.get("trace")
    if "flops_per_iter" not in data or not tr or not tr["device_events"]:
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]
