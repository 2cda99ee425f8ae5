"""az.wins_kernel_share: of the lanes the search's one-move win check ran
on in the traced iteration, the share the hand-written kernel checked: the
program's counter ``wins.kernel_rows`` over it plus ``wins.plain_rows``
(the plain tensor version, which runs for CPU tensors only), B a call of
``kernels/wins.py::winning_actions`` (every expansion's check of the new
node and the final pick's check of the roots).

The ``--trace 1`` pass of the ``az_train`` loop runs one steady iteration
after the window under ``torch.profiler``, which turns the program's spans
and counters on (``gobblet_rl_torch.utils.profiling``).  This reader runs
after that loop in the same process and reads the program's
``profiling.span_table()``; it returns ``None`` where the program records
neither counter, and without a CUDA card (the harness's own runs on the
CPU), where only the plain version can run and the share says nothing of
the card."""


def read(data):
    import torch

    from gobblet_rl_torch.utils import profiling

    if not torch.cuda.is_available():
        return None
    table = getattr(profiling, "span_table", None)
    counters = table()["counters"] if table else {}
    kernel = counters.get("wins.kernel_rows", 0)
    plain = counters.get("wins.plain_rows", 0)
    if not kernel + plain:
        return None
    return kernel / (kernel + plain)
