"""A later change adds a configuration's cell and a per-layer metric as new
files and new entries of BENCHMARK.json, editing no file the benchmark
has."""

import hashlib
import json

from benchmark.tests import checkout

READER = '''"""dummy.ring_rows: rows the window wrote into the ring, a count."""


def read(data):
    if "iterations" not in data:
        return None
    return float(data["iterations"])
'''


def digest(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_cell_and_metric_as_new_files(tmp_path):
    tiny = checkout.make(tmp_path)
    before = digest(tiny)
    wl_dir = tiny / "benchmark" / "workloads"
    wl = json.loads((wl_dir / "dqn_greedy.random-2m.json").read_text())
    wl.update(name="dqn_greedy.random-dummy", why="a dummy cell added as files")
    wl["traffic"]["dqn"]["num_envs"] = 32
    (wl_dir / "dqn_greedy.random-dummy.json").write_text(json.dumps(wl))
    (tiny / "benchmark" / "metrics" / "dummy.ring_rows.py").write_text(READER)
    spec = json.loads((tiny / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "dqn_greedy.random-dummy", "config": "dqn_greedy",
                              "traffic": "random-dummy", "chips": 1, "why": wl["why"]})
    spec["end_to_end"][0]["workloads"].append("dqn_greedy.random-dummy")
    spec["per_layer"].append({"name": "dummy.ring_rows", "unit": "rows", "better": "higher",
                              "source": "program_counter", "layer": "replay and learner",
                              "moves": "env_steps_per_s",
                              "workloads": ["dqn_greedy.random-dummy"]})
    (tiny / "BENCHMARK.json").write_text(json.dumps(spec))

    rc, out, err = checkout.run_cell(tiny, "dqn_greedy.random-dummy", trace=1)
    assert rc == 0, err
    line = checkout.last_line(out)
    assert line["correct"] is True
    assert "dummy.ring_rows" in line["metrics"]
    after = digest(tiny)
    assert {k: v for k, v in after.items() if k in before} == before
