"""The readers of the program's spans and counters: ``None`` on an empty
table, on a program without a span table and, for stream times, on spans
recorded without CUDA events; exact values on a planted table."""

import pytest

from benchmark.harness import common
from benchmark.tests import checkout
from gobblet_rl_torch.utils import profiling

STREAM = ["dqn.actor_ms", "dqn.opponent_ms", "dqn.engine_ms", "dqn.optimizer_ms"]
PLAY = ["play.decode_ms_p50", "play.upload_ms_p50", "play.launch_ms_p50",
        "play.readback_ms_p50"]
READERS = STREAM + ["dqn.opponent_played_share"] + PLAY


def reader(name):
    return common.load_module(checkout.REPO / "benchmark" / "metrics" / f"{name}.py",
                              f"bench_metric_{name.replace('.', '_')}")


def span(calls, roots, stream_ms, stream_self_ms, by_root):
    return {"calls": calls, "roots": roots, "host_ms": sum(by_root),
            "host_ms_by_root": by_root, "stream_ms": stream_ms,
            "stream_self_ms": stream_self_ms}


# two traced iterations and three traced moves
PLANTED = {
    "roots": 5,
    "spans": {
        "dqn.iteration": span(2, 2, 1300.0, 4.0, [650.0, 652.0]),
        "dqn.actor": span(36, 2, 300.0, 300.0, [90.0, 91.0]),
        "dqn.opponent": span(72, 2, 340.0, 340.0, [80.0, 82.0]),
        "dqn.engine": span(36, 2, 900.0, 560.0, [200.0, 201.0]),
        "dqn.update.step": span(16, 2, 9.0, 9.0, [3.0, 3.5]),
        "zoo.move": span(3, 3, 0.6, 0.3, [2.0, 2.4, 2.2]),
        "zoo.decode": span(3, 3, 0.0, 0.0, [0.05, 0.03, 0.04]),
        "zoo.upload": span(3, 3, 0.01, 0.01, [0.2, 0.1, 0.3]),
        "zoo.policy": span(3, 3, 0.1, 0.1, [1.0, 1.5, 1.2]),
        "zoo.readback": span(3, 3, 0.2, 0.2, [0.6, 0.7, 0.5]),
    },
    "counters": {"dqn.opponent_rows": 400.0, "dqn.opponent_rows_played": 220.0},
}
EXPECT = {"dqn.actor_ms": 150.0, "dqn.opponent_ms": 170.0, "dqn.engine_ms": 280.0,
          "dqn.optimizer_ms": 4.5, "dqn.opponent_played_share": 0.55,
          "play.decode_ms_p50": 0.04, "play.upload_ms_p50": 0.2, "play.launch_ms_p50": 1.2,
          "play.readback_ms_p50": 0.6}


@pytest.mark.parametrize("name", READERS)
def test_none_on_an_empty_table(name, monkeypatch):
    monkeypatch.setattr(profiling, "TABLE", profiling.SpanTable())
    assert reader(name).read({}) is None


@pytest.mark.parametrize("name", READERS)
def test_none_without_a_span_table(name, monkeypatch):
    """The parent of the spans' PR has no ``span_table``."""
    monkeypatch.delattr(profiling, "span_table")
    assert reader(name).read({}) is None


@pytest.mark.parametrize("name", READERS)
def test_exact_on_a_planted_table(name, monkeypatch):
    monkeypatch.setattr(profiling, "span_table", lambda: PLANTED)
    assert reader(name).read({}) == pytest.approx(EXPECT[name], rel=1e-12)


@pytest.mark.parametrize("name", STREAM)
def test_no_stream_time_without_events(name, monkeypatch):
    no_events = {**PLANTED, "spans": {k: {**v, "stream_ms": None, "stream_self_ms": None}
                                      for k, v in PLANTED["spans"].items()}}
    monkeypatch.setattr(profiling, "span_table", lambda: no_events)
    assert reader(name).read({}) is None
