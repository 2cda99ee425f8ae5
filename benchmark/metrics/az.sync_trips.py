"""az.sync_trips: the host syncs a search issues, the descent's and the
backup's (the counters ``az.descend_trips`` and ``az.backup_trips``, one
``bool(... .any())`` a trip after the first) per search (``az.searches``),
over the traced iteration.

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
    searches = counters.get("az.searches")
    if not searches or "az.descend_trips" not in counters:
        return None
    return (counters["az.descend_trips"] + counters.get("az.backup_trips", 0)) / searches
