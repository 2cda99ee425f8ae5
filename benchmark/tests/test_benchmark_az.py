"""The AlphaZero cell ``alphazero_gumbel32.selfplay-512k`` at a tiny size on
the CPU (the traffic's ``cpu_sizes``): a run is correct; a fault planted
in the program makes it incorrect (the backup without its change of side,
the halving skipped, the target flattened at the minority of roots with a
won child, half of each minibatch, the parameters left unchanged, one
ply's observation rows altered); the readers of the new
metrics return ``None`` where the program records nothing and exact
values on a planted table; the FLOPs module counts what the net needs;
no module of JAX is loaded."""

import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.flops import alphazero_gumbel32 as flops
from benchmark.harness import common
from benchmark.tests import checkout
from gobblet_rl_torch.utils import profiling

CELL = "alphazero_gumbel32.selfplay-512k"
SEED = 2**34 + 31
READERS = ["az.search_ms", "az.net_ms", "az.descend_ms", "az.wins_ms", "az.backup_ms",
           "az.learn_ms", "az.net_mfu", "az.mfu", "az.live_lane_share", "az.sync_trips",
           "az.device_idle_share"]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return checkout.make(tmp_path_factory.mktemp("checkout"))


def run_line(tiny, trace=0):
    rc, out, err = checkout.run_cell(tiny, CELL, seed=SEED, trace=trace)
    assert rc == 0, err
    return checkout.last_line(out)


@pytest.mark.parametrize("trace", [0, 1])
def test_correct(tiny, trace):
    line = run_line(tiny, trace)
    assert line["correct"] is True, line["checks"]
    assert line["checks"]["bad_rows"]["value"] == 0
    if trace:
        # the counters read on the CPU too; the stream times need a card
        assert {"az.live_lane_share", "az.sync_trips"} <= set(line["metrics"])


def run_false(tiny, name=None):
    line = run_line(tiny)
    assert line["correct"] is False, line["checks"]
    if name is not None:
        check = line["checks"][name]
        assert check["value"] > check["limit"], line["checks"]
    return line


def test_backup_without_its_sign(tiny, monkeypatch):
    from gobblet_rl_torch.search import gumbel_lm

    def backup(self, node, value, trips):
        for step in range(trips):
            if step and not bool((node > 0).any()):
                break
            nc = node.clamp(min=0)
            par = torch.where(node > 0, gumbel_lm._scal(self.parent, nc), -1)
            act = gumbel_lm._scal(self.pa, nc)
            upd = par >= 0
            edge = (par.clamp(min=0), act.clamp(min=0), self.lanes)
            self.N[edge] += upd.to(torch.float32)
            self.W[edge] += torch.where(upd, value, 0.0)
            node = par

    monkeypatch.setattr(gumbel_lm._Tree, "backup", backup)
    run_false(tiny, "visit_mismatch")


def test_halving_skipped(tiny, monkeypatch):
    from gobblet_rl_torch.search import gumbel_lm

    monkeypatch.setattr(gumbel_lm, "_phase_table", lambda n, m: np.zeros(n, np.int32))
    run_false(tiny, "visit_mismatch")


def test_target_flattened_where_a_child_is_won(tiny, monkeypatch):
    """A fault at a minority of roots: ``pi_gap`` (every root) fails it
    where the median against the reference search does not."""
    from gobblet_rl_torch.search import gumbel_lm

    original = gumbel_lm.gumbel_search_lm

    def search(*args, **kwargs):
        actions, pi, q, visits, root_v = original(*args, **kwargs)
        won = ((visits > 0) & (q >= 0.999)).any(1, keepdim=True)
        flat = pi.sqrt() / pi.sqrt().sum(1, keepdim=True)
        return actions, torch.where(won, flat, pi), q, visits, root_v

    monkeypatch.setattr(gumbel_lm, "gumbel_search_lm", search)
    line = run_false(tiny, "pi_gap")
    check = line["checks"]["pi_gap_search"]
    assert check["value"] <= check["limit"], line["checks"]


def test_half_batch(tiny, monkeypatch):
    from gobblet_rl_torch.train import alphazero

    original = alphazero.make_loss_fn

    def make_loss_fn(config):
        loss_fn = original(config)
        return lambda net, batch: loss_fn(net, {k: v[:v.shape[0] // 2] for k, v in batch.items()})

    monkeypatch.setattr(alphazero, "make_loss_fn", make_loss_fn)
    run_false(tiny)


def test_unchanged_parameters(tiny, monkeypatch):
    from gobblet_rl_torch.train import alphazero

    original = alphazero.make_update_phase

    def make_update_phase(config, *args, **kwargs):
        phase = original(config, *args, **kwargs)

        def update_phase(net, optimizer, *a, **k):
            saved = [p.detach().clone() for p in net.parameters()]
            out = phase(net, optimizer, *a, **k)
            with torch.no_grad():
                for p, s in zip(net.parameters(), saved):
                    p.copy_(s)
            return out

        return update_phase

    monkeypatch.setattr(alphazero, "make_update_phase", make_update_phase)
    run_false(tiny, "change_gap")


def test_one_ply_of_rows_altered(tiny, monkeypatch):
    """The third ply's observation rows carry the other seat's plane."""
    from gobblet_rl_torch.train import alphazero

    original, calls = alphazero._obs_bf, []

    def obs_bf(board, current):
        calls.append(None)
        obs = original(board, current)
        if len(calls) == 3:
            obs[:, 108:] = 1 - obs[:, 108:]
        return obs

    monkeypatch.setattr(alphazero, "_obs_bf", obs_bf)
    run_false(tiny, "bad_rows")


def reader(name):
    return common.load_module(checkout.REPO / "benchmark" / "metrics" / f"{name}.py",
                              f"bench_metric_{name.replace('.', '_')}")


@pytest.mark.parametrize("name", READERS)
def test_none_without_spans(name, monkeypatch):
    monkeypatch.setattr(profiling, "TABLE", profiling.SpanTable())
    assert reader(name).read({}) is None
    monkeypatch.delattr(profiling, "span_table")
    assert reader(name).read({}) is None


def span(stream_ms, roots=1):
    return {"calls": 1, "roots": roots, "host_ms": 1.0, "host_ms_by_root": [1.0],
            "stream_ms": stream_ms, "stream_self_ms": stream_ms}


PLANTED = {
    "roots": 1,
    "spans": {"az.search": span(16000.0), "az.net": span(8000.0), "az.descend": span(4000.0),
              "az.wins": span(3200.0), "az.backup": span(400.0), "az.updates": span(70.0)},
    "counters": {"az.searches": 8, "az.net_rows": 8 * 33 * 1000, "az.descend_trips": 600,
                 "az.backup_trips": 680, "az.lane_steps": 4000.0, "az.live_steps": 1000.0},
}
DATA = {"net_flops_per_row": 2_852_352, "peak_flops": 989e12, "flops_per_iter": 4e14,
        "iterations": 3, "window_s": 48.0, "trace": {"busy_s": 15.0, "window_s": 20.0,
                                                     "device_events": 10}}
EXPECT = {"az.search_ms": 2000.0, "az.net_ms": 1000.0, "az.descend_ms": 500.0,
          "az.wins_ms": 400.0, "az.backup_ms": 50.0, "az.learn_ms": 70.0,
          "az.net_mfu": 8 * 33 * 1000 * 2_852_352 / 8.0 / 989e12,
          "az.mfu": 4e14 * 3 / 48.0 / 989e12, "az.live_lane_share": 0.25, "az.sync_trips": 160.0,
          "az.device_idle_share": 0.25}


@pytest.mark.parametrize("name", READERS)
def test_exact_on_a_planted_table(name, monkeypatch):
    monkeypatch.setattr(profiling, "span_table", lambda: PLANTED)
    assert reader(name).read(DATA) == pytest.approx(EXPECT[name], rel=1e-12)


def test_flops_hand_count():
    fields = {"channels": 64, "blocks": 2, "num_envs": 524288, "segment_len": 8, "num_sims": 32,
              "batch_size": 2048, "updates_per_iter": 8}
    fwd = 2 * (9 * 9 * 13 * 64 + 4 * 9 * 9 * 64 * 64 + 576 * 55)
    assert fwd == flops.forward_per_row(fields) == 2_852_352
    search = 8 * 33 * 524288 * fwd
    learn = 8 * 2048 * (3 * fwd - 2 * 9 * 9 * 13 * 64)
    assert flops.per_iteration(fields) == search + learn
    assert 3.9e14 < search < 4.0e14


def test_flops_match_the_counter():
    """What ``FlopCounterMode`` counts while the program runs one iteration
    at a tiny size: every convolution and matmul of the search's
    evaluations and of the updates' forward and backward passes."""
    from gobblet_rl_torch.train import alphazero

    cfg = alphazero.AZConfig(search="gumbel_lm", num_envs=5, num_sims=4, segment_len=3,
                             batch_size=4, updates_per_iter=3, model="conv", channels=8,
                             blocks=2)
    gen = torch.Generator()
    gen.manual_seed(1)
    st = alphazero.init_alphazero(cfg, gen)
    iteration = alphazero.make_train_iteration(cfg)
    with FlopCounterMode(display=False) as counter:
        iteration(st, gen)
    fields = {k: getattr(cfg, k) for k in cfg.__dataclass_fields__}
    assert flops.per_iteration(fields) == counter.get_total_flops()


PROBE = """
import sys
sys.path.insert(0, {root!r})
from benchmark.tests import checkout
from pathlib import Path
rc, out, err = checkout.run_cell(Path({tmp!r}), {cell!r})
assert rc == 0, err
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'gobblet_rl_tpu'))
print('LOADED', bad)
"""


def test_run_loads_no_jax(tmp_path):
    tiny = checkout.make(tmp_path)
    code = PROBE.format(root=str(checkout.REPO), tmp=str(tiny), cell=CELL)
    out = subprocess.run([sys.executable, "-c", code], cwd=checkout.REPO, capture_output=True,
                         text=True, check=True)
    assert "LOADED []" in out.stdout
