"""dqn.actor_ms: the ms on the device's stream of the program's
``dqn.actor`` spans (each ply of collect: the legal mask, the features,
the Q-net's forward, the eps-greedy draw, the action's store) per traced
iteration, from the CUDA event pair each span records.

The ``--trace 1`` pass of the ``dqn_train`` loop runs one steady iteration
after the window under ``torch.profiler``, which turns the program's spans
and counters on (``gobblet_rl_torch.utils.profiling``).  This reader runs
after that loop in the same process and reads the program's
``profiling.span_table()``; it returns ``None`` where the program records
no such span (or, without CUDA events, no stream time)."""


def read(data):
    from gobblet_rl_torch.utils import profiling

    table = getattr(profiling, "span_table", None)
    span = table()["spans"].get("dqn.actor") if table else None
    if not span or span["stream_ms"] is None:
        return None
    return span["stream_ms"] / span["roots"]
