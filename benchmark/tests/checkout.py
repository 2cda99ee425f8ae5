"""A temporary checkout of the benchmark for the tests: ``BENCHMARK.json``
and ``benchmark/`` copied, the program linked, and cells shrunk to a
size the CPU runs in seconds."""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TINY_DQN = {"num_envs": 16, "buffer_size": 4096, "batch_size": 2048, "update_per_collect": 2}
TINY_TRAFFIC = {"check_envs": 8, "positions": 64, "warmup_moves": 2, "policy_moves": 8,
                "profile_moves": 4}


# the end-to-end metric each driver reports besides setup_s
DRIVER_METRIC = {"dqn_train": "env_steps_per_s", "host_play": "move_ms_p95"}


def make(tmp: Path, shrink: bool = True, cells: tuple = ()) -> Path:
    """The checkout; ``cells`` names workload files to enter into its
    BENCHMARK.json beside the cells there (a cell the benchmark keeps
    files for but does not list)."""
    shutil.copytree(REPO / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".pytest_cache"))
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    os.symlink(REPO / "gobblet_rl_torch", tmp / "gobblet_rl_torch")
    spec = json.loads((tmp / "BENCHMARK.json").read_text())
    for name in cells:
        wl = json.loads((tmp / "benchmark" / "workloads" / f"{name}.json").read_text())
        spec["workloads"].append({"name": name, "config": wl["config"],
                                  "traffic": name[len(wl["config"]) + 1:], "chips": 1,
                                  "why": wl["why"]})
        for m in spec["end_to_end"]:
            if m["name"] == DRIVER_METRIC[wl["driver"]]:
                m["workloads"].append(name)
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec, indent=2))
    if shrink:
        for p in (tmp / "benchmark" / "workloads").glob("*.json"):
            wl = json.loads(p.read_text())
            if wl["driver"] == "dqn_train":
                wl["traffic"]["dqn"].update(TINY_DQN)
            wl["traffic"].update({k: v for k, v in TINY_TRAFFIC.items() if k in wl["traffic"]})
            p.write_text(json.dumps(wl, indent=2))
    return tmp


def load_run(tmp: Path):
    spec = importlib.util.spec_from_file_location("bench_run_under_test",
                                                  tmp / "benchmark" / "run.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_cell(tmp: Path, cell: str, seed: int = 2**33 + 5, seconds: float = 0.5,
             trace: int = 0):
    """``(exit code, stdout, stderr)`` of one run on the CPU."""
    run = load_run(tmp)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], device="cpu")
    return rc, out.getvalue(), err.getvalue()


def last_line(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])
