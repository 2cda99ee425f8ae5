"""No module of JAX or the JAX package in a run's process: the run checks
``sys.modules`` by whole top-level names after its window and refuses to
print a result if it finds one."""

import subprocess
import sys
import types

from benchmark.tests import checkout

CELL = "dqn_greedy.random-2m"
PROBE = """
import sys
sys.path.insert(0, {root!r})
from benchmark.tests import checkout
from pathlib import Path
rc, out, err = checkout.run_cell(Path({tmp!r}), {cell!r})
assert rc == 0, err
bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'gobblet_rl_tpu'))
print('LOADED', bad)
"""


def test_run_loads_no_jax(tmp_path):
    tiny = checkout.make(tmp_path)
    code = PROBE.format(root=str(checkout.REPO), tmp=str(tiny), cell=CELL)
    out = subprocess.run([sys.executable, "-c", code], cwd=checkout.REPO, capture_output=True,
                         text=True, check=True)
    assert "LOADED []" in out.stdout


def test_prefix_is_not_a_match(tmp_path, monkeypatch):
    """``gobblet_rl_torch`` begins with the JAX package's name but is another
    top-level module; a module named ``jax`` is refused."""
    tiny = checkout.make(tmp_path)
    run = checkout.load_run(tiny)
    monkeypatch.setitem(sys.modules, "gobblet_rl_tpu_like", types.ModuleType("x"))
    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert run.loaded_forbidden() == ["jax.numpy"]
    rc, out, err = checkout.run_cell(tiny, CELL)
    assert rc == 3 and out.strip() == "" and "jax.numpy" in err
