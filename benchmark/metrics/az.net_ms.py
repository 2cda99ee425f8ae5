"""az.net_ms: the ms on the device's stream of the program's ``az.net`` spans
(every evaluation of the policy-value net at width B with its features,
legal mask, softmax and tanh: the root's and one a simulation) per search
of the traced iteration (the counter ``az.searches``), from the CUDA event
pair each span records.

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
    span = got["spans"].get("az.net")
    searches = got["counters"].get("az.searches")
    if not span or span["stream_ms"] is None or not searches:
        return None
    return span["stream_ms"] / searches
