"""dqn.draw_kernel_share: of the rows the uniform legal draw ran on in the
traced iteration, the share the hand-written kernel drew: the program's
counter ``draw.kernel_rows`` over it plus ``draw.plain_rows`` (the plain
tensor version, which runs for CPU tensors only), B a call of
``kernels/draw.py::random_legal_actions`` (the random opponent's replies
and openings and the actor's exploration draw in collect).

The ``--trace 1`` pass of the ``dqn_train`` loop runs one steady iteration
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
    kernel = counters.get("draw.kernel_rows", 0)
    plain = counters.get("draw.plain_rows", 0)
    if not kernel + plain:
        return None
    return kernel / (kernel + plain)
