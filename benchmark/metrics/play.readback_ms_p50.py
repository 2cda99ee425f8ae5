"""play.readback_ms_p50: the median over the traced moves of the host ms of
the program's ``zoo.readback`` span (the action read back as a host
integer, which waits for the device) inside the zoo agent's ``zoo.move``.

The ``--trace 1`` pass of the ``host_play`` loop plays the traffic's
``profile_moves`` moves (200) after the window under ``torch.profiler``,
which turns the program's spans on (``gobblet_rl_torch.utils.profiling``).
This reader runs after that loop in the same process and reads the
program's ``profiling.span_table()``; it returns ``None`` where the
program records no such span."""

import statistics


def read(data):
    from gobblet_rl_torch.utils import profiling

    table = getattr(profiling, "span_table", None)
    span = table()["spans"].get("zoo.readback") if table else None
    return statistics.median(span["host_ms_by_root"]) if span else None
