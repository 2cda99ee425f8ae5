"""az.live_lane_share: of the lane-steps the lockstep descent ran in the
traced iteration (the counter ``az.lane_steps``, B a step), the share in
which the lane was still walking down its tree (``az.live_steps``, the
live lanes of each step summed on the device): how much of the descent's
work is not a frozen lane's.

The ``--trace 1`` pass of the ``az_train`` loop runs one steady iteration
after the window under ``torch.profiler``, which turns the program's spans
and counters on (``gobblet_rl_torch.utils.profiling``).  This reader runs
after that loop in the same process and reads the program's
``profiling.span_table()``; it returns ``None`` where the program records
no such counter."""


def read(data):
    from gobblet_rl_torch.utils import profiling

    table = getattr(profiling, "span_table", None)
    counters = table()["counters"] if table else {}
    steps = counters.get("az.lane_steps")
    if not steps or "az.live_steps" not in counters:
        return None
    return counters["az.live_steps"] / steps
