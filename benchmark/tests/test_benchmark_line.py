"""A run's last line has the contract's keys, in order, and the cell's
metrics; without a card the command prints nothing and fails."""

import json
import subprocess
import sys

import pytest

from benchmark.tests import checkout

SPEC = json.loads((checkout.REPO / "BENCHMARK.json").read_text())
LISTED = [w["name"] for w in SPEC["workloads"]]
# workload files the benchmark keeps without listing them run as well
KEPT = sorted(p.stem for p in (checkout.REPO / "benchmark" / "workloads").glob("*.json")
              if p.stem not in LISTED)
CELLS = LISTED + KEPT
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return checkout.make(tmp_path_factory.mktemp("checkout"), cells=tuple(KEPT))


def expected(tiny, kind, cell):
    spec = json.loads((tiny / "BENCHMARK.json").read_text())
    return {m["name"] for m in spec[kind] if cell in m.get("workloads", [cell])}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_last_line(tiny, cell, trace):
    rc, out, err = checkout.run_cell(tiny, cell, trace=trace)
    assert rc == 0, err
    line = checkout.last_line(out)
    # the contract's keys, then the numbers compared under a key of their own, last
    assert list(line) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    kind = "per_layer" if trace else "end_to_end"
    # on the CPU no metric of the card's peak or trace can be read
    got = set(line["metrics"])
    assert got <= expected(tiny, kind, cell)
    if not trace:
        assert got == expected(tiny, kind, cell)
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # the numbers compared end stderr, each beside its limit
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split(":")[0] for t in tail] == [f"check {n}" for n in line["checks"]]


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", LISTED[0], "--seed",
                          "1", "--seconds", "1", "--trace", "0"], cwd=checkout.REPO,
                         capture_output=True, text=True, env={"CUDA_VISIBLE_DEVICES": "",
                                                              "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_bare_directory_fails(tmp_path):
    """Only BENCHMARK.json and the benchmark's files: the program is
    missing, so the run fails and prints no result."""
    bare = checkout.make(tmp_path, shrink=True)
    (bare / "gobblet_rl_torch").unlink()
    out = subprocess.run([sys.executable, "-c",
                          "import sys, runpy; sys.argv = ['run.py', '--workload', "
                          f"'{LISTED[0]}', '--seed', '3', '--seconds', '1', '--trace', '0']; "
                          "import benchmark.run as r; sys.exit(r.main(device='cpu'))"],
                         cwd=bare, capture_output=True, text=True, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""
