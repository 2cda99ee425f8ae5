"""az.net_mfu: the net's share of the card's dense bf16 peak where it runs:
the rows it evaluated in the traced iteration (the counter
``az.net_rows``) times the FLOPs of a forward a row
(``benchmark/flops/<config>.py::forward_per_row``, from the widths),
over the ms on the device's stream of the ``az.net`` spans (which hold
the features, the legal mask and the softmax too) and the peak; a ratio.

The ``--trace 1`` pass of the ``az_train`` loop runs one steady iteration
after the window under ``torch.profiler``, which turns the program's spans
and counters on (``gobblet_rl_torch.utils.profiling``).  This reader runs
after that loop in the same process and reads the program's
``profiling.span_table()``; it returns ``None`` where the program records
no such span or counter, and without a card's peak."""


def read(data):
    from gobblet_rl_torch.utils import profiling

    table = getattr(profiling, "span_table", None)
    got = table() if table else {"spans": {}, "counters": {}}
    span = got["spans"].get("az.net")
    rows = got["counters"].get("az.net_rows")
    if not span or span["stream_ms"] is None or not rows or not data.get("peak_flops"):
        return None
    return rows * data["net_flops_per_row"] / (span["stream_ms"] * 1e-3) / data["peak_flops"]
