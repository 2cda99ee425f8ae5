"""On a CUDA card: every cell runs end to end, once with each trace
setting, and reports ``correct`` true.  Skips without a card.

    python -m pytest benchmark/tests -m card
"""

import json
import subprocess
import sys

import pytest
import torch

from benchmark.tests import checkout

SPEC = json.loads((checkout.REPO / "BENCHMARK.json").read_text())


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_on_the_card(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          str(2**33 + 3), "--seconds", "3", "--trace", str(trace)],
                         cwd=checkout.REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = checkout.last_line(out.stdout)
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
