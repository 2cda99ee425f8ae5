"""dqn.opponent_played_share: of the rows the opponent's policy ran on
in collect (the program's counter ``dqn.opponent_rows``, B a call), the
share whose move changed the env's state (``dqn.opponent_rows_played``:
the envs not ended by the learner's ply, then those whose learner sits
second after a reset), over the traced iteration.  The played count is
summed on the device and read with the table.

The ``--trace 1`` pass of the ``dqn_train`` loop runs one steady iteration
after the window under ``torch.profiler``, which turns the program's spans
and counters on (``gobblet_rl_torch.utils.profiling``).  This reader runs
after that loop in the same process and reads the program's
``profiling.span_table()``; it returns ``None`` where the program records
no such counter."""


def read(data):
    from gobblet_rl_torch.utils import profiling

    table = getattr(profiling, "span_table", None)
    counters = table()["counters"] if table else {}
    rows = counters.get("dqn.opponent_rows")
    if not rows or "dqn.opponent_rows_played" not in counters:
        return None
    return counters["dqn.opponent_rows_played"] / rows
