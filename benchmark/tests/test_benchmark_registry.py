"""Every entry of BENCHMARK.json resolves to its files by name, and the
file keeps to the benchmark contract's form."""

import json
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "benchmark"
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"]
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_config_resolves(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"])
    assert cfg["file"] == f"benchmark/configs/{cfg['name']}.json"
    data = json.loads((REPO / cfg["file"]).read_text())
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert (BENCH / "flops" / f"{cfg['name']}.py").exists()
    assert any(w["config"] == cfg["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] == 1
    assert 1 <= len(cell["why"]) <= 200 and "\n" not in cell["why"]
    wl = json.loads((BENCH / "workloads" / f"{cell['name']}.json").read_text())
    assert wl["name"] == cell["name"] and wl["config"] == cell["config"]
    assert wl["why"] == cell["why"]
    assert cell["name"] == f"{cell['config']}.{cell['traffic']}"
    assert (BENCH / "drivers" / f"{wl['driver']}.py").exists()
    assert all(v is not None for v in wl["limits"].values())


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_resolves(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    path = BENCH / "metrics" / f"{metric['name']}.py"
    assert "def read(data)" in path.read_text()
    cells = {w["name"] for w in SPEC["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if metric in SPEC["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        e2e = {m["name"]: m for m in SPEC["end_to_end"]}
        assert metric["moves"] in e2e
        reported = set(e2e[metric["moves"]].get("workloads", cells))
        assert set(metric["workloads"]) <= reported


def test_every_cell_reports_enough():
    for cell in SPEC["workloads"]:
        def has(m):
            return cell["name"] in m.get("workloads", [cell["name"]])
        e2e = [m["name"] for m in SPEC["end_to_end"] if has(m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(has(m) for m in SPEC["per_layer"])


def test_names_are_unique():
    for key in ("configs", "workloads"):
        names = [x["name"] for x in SPEC[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
