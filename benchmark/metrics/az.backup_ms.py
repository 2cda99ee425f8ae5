"""az.backup_ms: the ms on the device's stream of the program's ``az.backup``
spans (each simulation's backup up the parent pointers, with its host
syncs) per search of the traced iteration (the counter ``az.searches``),
from the CUDA event pair each span records.

The ``--trace 1`` pass of the ``az_train`` loop runs one steady iteration
after the window under ``torch.profiler``, which turns the program's spans
and counters on (``gobblet_rl_torch.utils.profiling``).  This reader runs
after that loop in the same process and reads the program's
``profiling.span_table()``; it returns ``None`` where the program records
no such span or counter (or, without CUDA events, no stream time)."""


def read(data):
    from gobblet_rl_torch.utils import profiling

    table = getattr(profiling, "span_table", None)
    got = table() if table else {"spans": {}, "counters": {}}
    span = got["spans"].get("az.backup")
    searches = got["counters"].get("az.searches")
    if not span or span["stream_ms"] is None or not searches:
        return None
    return span["stream_ms"] / searches
