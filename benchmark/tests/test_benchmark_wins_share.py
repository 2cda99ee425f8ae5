"""The reader of ``az.wins_kernel_share``, beside the readers of
``test_benchmark_span_metrics.py``: ``None`` on an empty table, on a
program without a span table, on one without the win check's counters and
without a card; the exact share on planted tables (a card stood in)."""

import pytest
import torch

from benchmark.tests.test_benchmark_span_metrics import PLANTED, reader
from gobblet_rl_torch.utils import profiling

NAME = "az.wins_kernel_share"


@pytest.fixture(autouse=True)
def card(monkeypatch):
    """A card stands in: the reader reads nothing on a host without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)


def test_none_without_a_card(monkeypatch):
    """On the CPU the plain rows are all there is to count."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    planted = {**PLANTED, "counters": {"wins.plain_rows": 2112.0}}
    monkeypatch.setattr(profiling, "span_table", lambda: planted)
    assert reader(NAME).read({}) is None


def test_none_on_an_empty_table(monkeypatch):
    monkeypatch.setattr(profiling, "TABLE", profiling.SpanTable())
    assert reader(NAME).read({}) is None


def test_none_without_a_span_table(monkeypatch):
    monkeypatch.delattr(profiling, "span_table")
    assert reader(NAME).read({}) is None


def test_none_without_the_win_check_counters(monkeypatch):
    """The parent of the win kernel records the search's counters only."""
    planted = {**PLANTED, "counters": {"az.searches": 8.0, "az.net_rows": 1.4e8}}
    monkeypatch.setattr(profiling, "span_table", lambda: planted)
    assert reader(NAME).read({}) is None


@pytest.mark.parametrize("counters, share", [
    ({"wins.kernel_rows": 138412032.0}, 1.0),
    ({"wins.plain_rows": 2112.0}, 0.0),
    ({"wins.kernel_rows": 96.0, "wins.plain_rows": 32.0}, 0.75),
])
def test_exact_on_a_planted_table(counters, share, monkeypatch):
    planted = {**PLANTED, "counters": {**PLANTED["counters"], **counters}}
    monkeypatch.setattr(profiling, "span_table", lambda: planted)
    assert reader(NAME).read({}) == pytest.approx(share, rel=1e-12)
