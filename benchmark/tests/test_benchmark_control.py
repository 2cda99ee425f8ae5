"""The control fails: the reference put in the program's place one
precision down (every matmul operand through float8 e4m3, the step below
the configuration's bfloat16) reads above a limit of the cell, here at a
size a CPU test holds.  On the card, ``benchmark/calibrate.py`` reads it
at the cells' own sizes."""

import json
import time

import pytest
import torch

from benchmark.harness import common
from benchmark.tests import checkout

BENCH = checkout.REPO / "benchmark"


def context(tiny, cell, seed):
    wl = json.loads((tiny / "benchmark" / "workloads" / f"{cell}.json").read_text())
    config = json.loads((tiny / "benchmark" / "configs" / f"{wl['config']}.json").read_text())
    driver = common.load_module(BENCH / "drivers" / f"{wl['driver']}.py",
                                f"bench_driver_{wl['driver']}")
    ctx = common.Context(workload=wl, config=config, flops=None, seed=seed, seconds=0,
                         trace=False, device=torch.device("cpu"), started=time.perf_counter())
    return ctx, driver, wl["limits"]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return checkout.make(tmp_path_factory.mktemp("checkout"), cells=("dqn_greedy.recipe",))


def calibrate():
    return common.load_module(BENCH / "calibrate.py", "bench_calibrate")


@pytest.mark.parametrize("cell", ["dqn_greedy.recipe", "dqn_greedy.random-2m"])
def test_training_control_fails(tiny, cell):
    ctx, driver, limits = context(tiny, cell, 2**33 + 29)
    readings = calibrate().training(ctx, driver)
    program, control = readings["program"], readings["control"]
    compared = [k for k in limits if k != "bad_transitions"]
    assert all(program[k] <= limits[k] for k in compared)
    assert any(control[k] > limits[k] for k in compared), control
    half = readings["half_batch"]
    assert any(half[k] > limits[k] for k in compared), half


def test_play_control_fails(tiny):
    """Over the cell's own count of positions: a near tie that float8 breaks
    the other way is rare, so few positions would show none."""
    ctx, driver, limits = context(tiny, "dqn_greedy.play-b1", 2**33 + 31)
    ctx.workload["traffic"]["positions"] = 4096
    readings = calibrate().play(ctx, driver)
    assert readings["program"]["q_gap"] <= limits["q_gap"]
    assert readings["control"]["q_gap"] > limits["q_gap"], readings
