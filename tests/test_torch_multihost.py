"""The port's multi-process training (``gobblet_rl_torch/parallel/
multihost.py``), the twin of tests/test_multihost.py: ``launch_local``
spawns real OS processes, one a rank, that join a gloo process group on
localhost and run the data-parallel iteration of each family, so the
gradient ``all_reduce`` crosses process boundaries.  Every rank runs with
an import hook that refuses JAX, flax, optax and the JAX package, so a
rank that reached for one of them would fail."""

import os
import subprocess
import sys

import numpy as np
import pytest

from gobblet_rl_torch.parallel.multihost import launch_local

BLOCKER = '''
import importlib.abc, sys

class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "gobblet_rl_tpu"):
            raise ImportError(f"a torch rank imported {name}")
        return None

sys.meta_path.insert(0, _Refuse())
'''


@pytest.fixture
def no_jax_in_ranks(tmp_path, monkeypatch):
    """A ``sitecustomize`` on the ranks' path that refuses the JAX side."""
    (tmp_path / "sitecustomize.py").write_text(BLOCKER)
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))


def test_multihost_dqn_iteration(no_jax_in_ranks):
    results = launch_local(2, 2, iterations=2, num_envs=8 * 2 * 2, device="cpu", timeout=120)
    assert [r["rank"] for r in results] == [0, 1, 2, 3]
    assert [r["process_id"] for r in results] == [0, 0, 1, 1]
    for r in results:
        assert r["processes"] == 2 and r["devices"] == 4   # the GLOBAL topology
        assert np.isfinite(r["loss"])
        assert r["grad_steps"] == 4   # 2 iterations x update_per_collect=2
    assert len({r["digest"] for r in results}) == 1
    assert len({r["loss"] for r in results}) == 1


@pytest.mark.parametrize("family", ["az", "ppo"])
def test_multihost_other_families(family, no_jax_in_ranks):
    results = launch_local(2, 2, iterations=1, num_envs=16, family=family, device="cpu",
                           timeout=120)
    assert len(results) == 4
    assert all(r["family"] == family and np.isfinite(r["loss"]) for r in results)
    assert len({r["digest"] for r in results}) == 1


def test_the_hook_refuses_jax_and_failures_raise(no_jax_in_ranks):
    """The hook works (a process on the ranks' path cannot import jax), and
    a failing rank makes the launcher raise with its error."""
    out = subprocess.run([sys.executable, "-c", "import jax"], capture_output=True, text=True,
                         env=dict(os.environ), timeout=60)
    assert out.returncode != 0 and "a torch rank imported jax" in out.stderr
    with pytest.raises(RuntimeError, match="invalid choice: 'nope'"):
        launch_local(1, 2, iterations=1, family="nope", device="cpu", timeout=60)
