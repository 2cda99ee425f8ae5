"""az.learn_ms: the ms on the device's stream of the program's
``az.updates`` span (the iteration's minibatched AdamW updates) per
traced iteration, from the CUDA event pair the span records.

The ``--trace 1`` pass of the ``az_train`` loop runs one steady iteration
after the window under ``torch.profiler``, which turns the program's spans
and counters on (``gobblet_rl_torch.utils.profiling``).  This reader runs
after that loop in the same process and reads the program's
``profiling.span_table()``; it returns ``None`` where the program records
no such span (or, without CUDA events, no stream time)."""


def read(data):
    from gobblet_rl_torch.utils import profiling

    table = getattr(profiling, "span_table", None)
    span = table()["spans"].get("az.updates") if table else None
    if not span or span["stream_ms"] is None:
        return None
    return span["stream_ms"] / span["roots"]
