"""``make_zoo`` of the port: the ``--quick`` pipeline into a zoo directory
that the JAX package's ``zoo.load`` reads (as ``tests/test_zoo.py`` runs
the JAX script), and every recipe's config equal to the JAX script's,
field for field, full and ``--quick`` (each maker's ``train`` call is
captured in both packages)."""

import argparse
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from gobblet_rl_torch import zoo as tzoo
from gobblet_rl_torch.ops import batched_core as tbc
from gobblet_rl_torch.scripts import make_zoo as tmake
from gobblet_rl_torch.train import alphazero as taz
from gobblet_rl_torch.train import dqn as tdqn
from gobblet_rl_torch.train import ppo as tppo
from gobblet_rl_tpu import zoo as jzoo
from gobblet_rl_tpu.ops import batched_core as jbc
from gobblet_rl_tpu.train import alphazero as jaz
from gobblet_rl_tpu.train import dqn as jdqn
from gobblet_rl_tpu.train import ppo as jppo
from tests.torch_parity import CPU

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes on a few cores, where torch's thread pools would oversubscribe
    them and small ops slow down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_quick_pipeline_writes_a_zoo_jax_reads(tmp_path, monkeypatch):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO),
           "OMP_NUM_THREADS": "1"}
    env.pop("GOBBLET_ZOO_DIR", None)
    r = subprocess.run(
        [sys.executable, "-m", "gobblet_rl_torch.scripts.make_zoo", "--quick", "--entries",
         "ppo_league", "--eval-games", "8", "--device", "cpu", "--zoo-dir", str(tmp_path)],
        cwd=REPO, env=env, timeout=300, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-2000:]
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    row = manifest["ppo_league"]
    assert row["family"] == "ppo" and "vs_random" in row["metrics"]
    assert row["recipe"].startswith("gobblet_rl_torch/scripts/make_zoo.py: PPOConfig(")
    assert "mixed_weights=(0.1, 0.7, 0.2)" in row["recipe"]   # no AZ entry: no search leg
    assert (tmp_path / "ppo_league.msgpack").stat().st_size > 1000

    monkeypatch.setenv("GOBBLET_ZOO_DIR", str(tmp_path))
    assert jzoo.names() == ["ppo_league"] == tzoo.names()
    pol = jzoo.policy("ppo_league")
    state = jbc.reset_planes(4)
    actions = pol(jax.random.PRNGKey(0), state.board, state.current)
    mask = np.asarray(jbc.legal_mask_planes(state.board, state.current))
    assert all(mask[a, i] for i, a in enumerate(np.asarray(actions)))
    tpol = tzoo.policy("ppo_league", device=CPU)
    tstate = tbc.reset_planes(4, CPU)
    tactions = tpol(torch.Generator().manual_seed(0), tstate.board, tstate.current)
    tmask = tbc.legal_mask_planes(tstate.board, tstate.current)
    assert bool(tmask[tactions.long(), torch.arange(4)].all())


class Captured(Exception):
    def __init__(self, config):
        self.config = config


def capture(fn, *args):
    with pytest.raises(Captured) as info:
        fn(*args)
    return info.value.config


def jax_script():
    spec = importlib.util.spec_from_file_location("jax_make_zoo", REPO / "scripts" / "make_zoo.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def fields(config) -> dict:
    return {f.name: getattr(config, f.name) for f in dataclasses.fields(config)}


# entry -> (JAX train module, the port's)
TRAINERS = {"alphazero_gumbel32": (jaz, taz), "dqn_greedy": (jdqn, tdqn),
            "ppo_league": (jppo, tppo)}


@pytest.mark.parametrize("quick", [False, True])
@pytest.mark.parametrize("entry,with_az", [("alphazero_gumbel32", True), ("dqn_greedy", True),
                                           ("ppo_league", True), ("ppo_league", False)])
def test_recipes_equal_jax(entry, with_az, quick, tmp_path, monkeypatch):
    """``with_az``: the zoo being written holds ``alphazero_gumbel32`` (the
    committed zoo) or nothing (an empty directory), which decides the PPO
    league's legs in both packages."""
    if with_az:
        monkeypatch.delenv("GOBBLET_ZOO_DIR", raising=False)
    else:
        monkeypatch.setenv("GOBBLET_ZOO_DIR", str(tmp_path))
    jmod, tmod = TRAINERS[entry]

    def raise_config(config, *args, **kwargs):
        raise Captured(config)

    monkeypatch.setattr(jmod, "train", raise_config)
    monkeypatch.setattr(tmod, "train", raise_config)
    args = argparse.Namespace(quick=quick, seed=1626, eval_games=8)
    want = capture(jax_script().__dict__[{"alphazero_gumbel32": "make_alphazero",
                                          "dqn_greedy": "make_dqn",
                                          "ppo_league": "make_ppo"}[entry]], args)
    got = capture(tmake.MAKERS[entry], args, CPU)
    assert fields(got) == fields(want)
    assert type(got).__name__ == type(want).__name__
    if entry == "ppo_league":
        assert len(got.mixed_weights) == (4 if with_az else 3)


def test_cli_needs_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmake.main(["--quick", "--entries", "ppo_league", "--zoo-dir", str(tmp_path)])
    assert not list(tmp_path.iterdir())
