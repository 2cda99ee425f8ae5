"""play.device_idle_share: the share of a profiled stretch of moves (after
the window) in which no kernel, copy or fill ran on the card."""


def read(data):
    tr = data.get("trace")
    if "move_ms" not in data or not tr or not tr["device_events"]:
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]
