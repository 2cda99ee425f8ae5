"""The port's timing tools against the repository's JAX ones:
``gobblet_rl_torch/scripts/bench.py`` (bench.py), ``bench_scaling.py``
(bench_scaling.py) and ``sweep_train_envs.sh`` (scripts/sweep_train_envs.sh).

* The bench on the CPU, at the tiny sizes of tests/test_examples.py's
  ``test_bench_cli_json_contract``: its stdout holds bench.py's metric
  names in bench.py's order, each line with bench.py's keys (read from
  bench.py's source) but for the cost-model fields listed below, and the
  headline last.
* The DQN, AlphaZero and PPO configurations it builds equal the ones
  bench.py builds, field for field (bench.py's calls captured where it
  hands them on), at bench.py's defaults and at the tiny sizes; the work
  counted an iteration is bench.py's.
* ``bench_scaling`` on two gloo ranks prints sizes 1 and 2 and the summary.
* The sweep prefixes each JSON line with its configuration, drops
  anything else and records a section that fails, against a fake bench.
"""

import ast
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch

from gobblet_rl_torch.scripts import bench as tbench
from gobblet_rl_torch.scripts import bench_scaling as tscaling
from gobblet_rl_tpu.train import alphazero as jaz
from gobblet_rl_tpu.train import dqn as jdqn
from gobblet_rl_tpu.train import ppo as jppo

REPO = Path(__file__).resolve().parents[1]
TINY = {
    "GOBBLET_BENCH_BATCH": "512",
    "GOBBLET_BENCH_STEPS": "8",
    "GOBBLET_BENCH_REPEATS": "2",
    "GOBBLET_BENCH_TRAIN_ENVS": "64",
    "GOBBLET_BENCH_AZ_ENVS": "16",
    "GOBBLET_BENCH_AZ_SIMS": "4",
    "GOBBLET_BENCH_AZ_SEGMENT": "8",
    "GOBBLET_BENCH_PPO_ENVS": "64",
    "GOBBLET_BENCH_PPO_SEGMENT": "8",
}
ORDER = ["dqn_train_env_steps_per_sec", "az_train_env_steps_per_sec",
         "ppo_train_env_steps_per_sec", "rollout_roofline", "env_steps_per_sec"]
# bench.py's roofline fields from XLA's cost model that torch cannot count
# (no compiled cost model for bytes), and the FLOP count named after its
# counter
NOT_COUNTED = {"xla_bytes_per_iter", "hbm_gbytes_per_sec", "hbm_util"}
RENAMED = {"xla_flops_per_iter": "flop_counter_flops_per_iter"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes on a few cores, where torch's thread pools would oversubscribe
    them and small ops slow down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def run(args, extra_env, timeout=240, path=None):
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1", **extra_env}
    if path is not None:
        env["PATH"] = f"{path}:{env['PATH']}"
    return subprocess.run(args, cwd=REPO, env=env, timeout=timeout, capture_output=True,
                          text=True)


def bench_py_keys() -> tuple[dict, set]:
    """({metric: keys of its line}, the keys ``roofline`` adds), read from
    bench.py's source."""
    tree = ast.parse((REPO / "bench.py").read_text())
    lines = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys = [k.value for k in node.keys if isinstance(k, ast.Constant)]
            if "metric" in keys:
                metric = node.values[keys.index("metric")]
                lines[metric.value] = set(keys)
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "roofline")
    roof = {t.slice.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
            for t in n.targets if isinstance(t, ast.Subscript)}
    return lines, roof


def test_bench_cli_json_contract():
    r = run([sys.executable, "-m", "gobblet_rl_torch.scripts.bench"],
            {**TINY, "GOBBLET_BENCH_DEVICE": "cpu"})
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [json.loads(line) for line in r.stdout.strip().splitlines()]
    assert [rec["metric"] for rec in lines] == ORDER

    want, roof = bench_py_keys()
    assert set(want) == set(ORDER)
    assert roof >= NOT_COUNTED | set(RENAMED) | {"tflops_per_sec", "mfu"}
    port_roof = {RENAMED.get(k, k) for k in roof - NOT_COUNTED}
    for rec in lines:
        name = rec["metric"]
        extra = port_roof if name.endswith("_train_env_steps_per_sec") else set()
        assert set(rec) == want[name] | extra, name

    head = lines[-1]
    assert head["value"] > 0 and head["vs_baseline"] > 0 and head["unit"] == "steps/s"
    for rec in lines[:3]:
        assert rec["iterations_per_sec"] > 0 and rec["value"] > 0, rec["metric"]
        assert rec["flop_counter_flops_per_iter"] > 0 and rec["tflops_per_sec"] >= 0
        assert rec["mfu"] is None   # no peak of the CPU: the MFU is the card's
    aux = lines[3]
    assert aux["bytes_per_env_step"] == round(tbench.kernel_bytes(512) / (512 * 8), 4)
    assert aux["flops_per_env_step"] == 0.0 and aux["hbm_util"] is None
    # the CPU runs the kernel's plain version: no launch; the engine and
    # the baseline go to stderr only
    assert "# rollout kernel launches: 0" in r.stderr
    assert "# rollout engine median" in r.stderr and "# baseline: " in r.stderr
    assert "# device: cpu" in r.stderr


class Captured(Exception):
    def __init__(self, config):
        self.config = config


def capture(fn, *args):
    with pytest.raises(Captured) as info:
        fn(*args)
    return info.value.config


def fields(config) -> dict:
    return {f.name: getattr(config, f.name) for f in dataclasses.fields(config)}


def load_bench_py():
    """bench.py as a module (it reads its variables on import), with the
    compilation cache it configures put back as it was."""
    saved = {k: getattr(jax.config, k) for k in
             ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")}
    try:
        spec = importlib.util.spec_from_file_location("jax_bench", REPO / "bench.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return module


@pytest.mark.parametrize("sizes", ["defaults", "tiny"])
def test_configs_and_work_equal_bench_py(sizes, monkeypatch):
    for k in [*TINY, "GOBBLET_BENCH_AZ_SEARCH", "GOBBLET_BENCH_ONLY", "GOBBLET_BENCH_DEVICE"]:
        monkeypatch.delenv(k, raising=False)
    if sizes == "tiny":
        for k, v in TINY.items():
            monkeypatch.setenv(k, v)
    jbench = load_bench_py()

    def raise_config(config, *args, **kwargs):
        raise Captured(config)

    monkeypatch.setattr(jdqn, "init_train_state", raise_config)
    monkeypatch.setattr(jaz, "init_alphazero", raise_config)
    monkeypatch.setattr(jppo, "init_ppo", raise_config)
    s = tbench.Settings.from_env()
    assert (s.batch, s.steps, s.repeats) == (jbench.BATCH, jbench.STEPS, jbench.REPEATS)
    for jfn, tfn in ((jbench.bench_dqn_train, tbench.dqn_config),
                     (jbench.bench_az_train, tbench.az_config),
                     (jbench.bench_ppo_train, tbench.ppo_config)):
        want, got = capture(jfn), tfn(s)
        assert type(got).__name__ == type(want).__name__
        assert fields(got) == fields(want), type(got).__name__

    # the work an iteration, as bench.py:203, 255 and 306 count it
    dqn_c, az_c, ppo_c = tbench.dqn_config(s), tbench.az_config(s), tbench.ppo_config(s)
    assert tbench.dqn_env_steps_per_iter(dqn_c) == dqn_c.num_envs * (
        dqn_c.segment_len + dqn_c.n_step - 1)
    assert tbench.az_moves_per_iter(az_c) == az_c.num_envs * az_c.segment_len
    assert tbench.ppo_env_steps_per_iter(ppo_c) == ppo_c.num_envs * ppo_c.segment_len
    if sizes == "defaults":
        assert tbench.dqn_env_steps_per_iter(dqn_c) == 262144 * 18
        assert s.device is None and not s.only
    assert tbench.TIMED_ITERS == {"dqn": 8, "az": 4, "ppo": 8} and tbench.WARMUP == 2


def test_settings_read_only_and_device(monkeypatch):
    monkeypatch.setenv("GOBBLET_BENCH_ONLY", "dqn,,ppo")
    monkeypatch.setenv("GOBBLET_BENCH_DEVICE", "cpu")
    monkeypatch.setenv("GOBBLET_BENCH_AZ_SEARCH", "gumbel")
    s = tbench.Settings.from_env()
    assert s.only == {"dqn", "ppo"} and s.device == "cpu" and s.az_search == "gumbel"
    assert [sec for sec in ("dqn", "az", "ppo", "rollout") if s.want(sec)] == ["dqn", "ppo"]


def test_tools_need_the_card_by_default(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.delenv("GOBBLET_BENCH_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbench.main()
    monkeypatch.setattr(tscaling, "FORCE_CPU", False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tscaling.main()


def test_bench_scaling_cli():
    r = run([sys.executable, "-m", "gobblet_rl_torch.scripts.bench_scaling"],
            {"GOBBLET_SCALING_FORCE_CPU": "1", "GOBBLET_SCALING_MAX_DEVICES": "2",
             "GOBBLET_SCALING_BATCH": "512", "GOBBLET_SCALING_STEPS": "8",
             "GOBBLET_SCALING_REPEATS": "1"})
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [json.loads(line) for line in r.stdout.strip().splitlines()]
    assert lines[-1]["metric"] == "weak_scaling_efficiency"
    assert lines[-1]["devices"] == 2 and lines[-1]["per_device_batch"] == 512
    per_size = [rec for rec in lines if rec["metric"] == "weak_scaling_env_steps_per_sec"]
    assert [rec["devices"] for rec in per_size] == [1, 2]
    assert [rec["batch"] for rec in per_size] == [512, 1024]
    assert all(rec["value"] > 0 for rec in per_size)


FAKE_BENCH = """#!/bin/bash
# a fake python: one JSON line naming the section and its env count, a
# stray line, a line on stderr; the 4,096-env PPO section fails
envs=${GOBBLET_BENCH_TRAIN_ENVS:-}${GOBBLET_BENCH_PPO_ENVS:-}${GOBBLET_BENCH_AZ_ENVS:-}
echo "{\\"metric\\": \\"${GOBBLET_BENCH_ONLY}_train_env_steps_per_sec\\", \\"envs\\": $envs, \\"args\\": \\"$*\\"}"
echo "not json"
echo "to stderr" >&2
[[ $envs == 4096 && $GOBBLET_BENCH_ONLY == ppo ]] && exit 3
exit 0
"""


def test_sweep_prefixes_lines_and_records_failures(tmp_path):
    fake = tmp_path / "bin"
    fake.mkdir()
    (fake / "python").write_text(FAKE_BENCH)
    (fake / "python").chmod(0o755)
    out = tmp_path / "sweep.jsonl"
    r = run(["bash", str(REPO / "gobblet_rl_torch/scripts/sweep_train_envs.sh"), str(out),
             "dqn,ppo"], {}, timeout=60, path=fake)
    assert r.returncode == 0, r.stderr
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert rows == [json.loads(line) for line in r.stdout.splitlines()]
    ok = [row for row in rows if not row["metric"].endswith("_FAILED")]
    assert [(row["config"], row["envs"]) for row in ok] == (
        [(f"GOBBLET_BENCH_TRAIN_ENVS={n}", n) for n in (16384, 32768, 65536, 131072)]
        + [(f"GOBBLET_BENCH_PPO_ENVS={n}", n) for n in (2048, 4096, 8192, 16384)])
    assert all(row["args"] == "-m gobblet_rl_torch.scripts.bench" for row in ok)
    assert [row for row in rows if row["metric"].endswith("_FAILED")] == [
        {"config": "GOBBLET_BENCH_PPO_ENVS=4096", "metric": "ppo_FAILED", "exit": 3}]
    assert "WARN: non-JSON bench output dropped: not json" in r.stderr
    assert "WARN: section 'ppo GOBBLET_BENCH_PPO_ENVS=4096' exited 3" in r.stderr
    assert (tmp_path / "sweep.log").read_text().count("to stderr") == 8
