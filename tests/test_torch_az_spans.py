"""The AlphaZero iteration's and the Gumbel search's spans and counters
(``utils/profiling.py``): how the spans nest, the counters' exact values
for a tiny search (from the reference search's own walk), and nothing
recorded while ``torch.profiler`` is off."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.harness import traffic
from benchmark.reference import az_search
from gobblet_rl_torch.models import actor_critic as ac
from gobblet_rl_torch.ops import batched_core as bc
from gobblet_rl_torch.search import gumbel, gumbel_lm
from gobblet_rl_torch.train import alphazero
from gobblet_rl_torch.utils import profiling

CPU = torch.device("cpu")
PARENTS = {
    "az.iteration": {None},
    "az.segment": {"az.iteration"}, "az.outcomes": {"az.iteration"},
    "az.updates": {"az.iteration"},
    "az.search": {"az.segment"}, "az.step": {"az.segment"},
    "az.root": {"az.search"}, "az.descend": {"az.search"}, "az.expand": {"az.search"},
    "az.backup": {"az.search"},
    "az.net": {"az.root", "az.expand"}, "az.wins": {"az.expand", "az.search"},
}


@pytest.fixture
def table(monkeypatch):
    """A fresh span table that also keeps each span's parent's name."""
    fresh = profiling.SpanTable()
    fresh.edges = set()
    add = fresh._add

    def keep(root):
        fresh.edges |= {(s.name, s.parent.name if s.parent else None) for s in root.spans}
        add(root)

    monkeypatch.setattr(fresh, "_add", keep)
    monkeypatch.setattr(profiling, "TABLE", fresh)
    return fresh


def tiny_iteration():
    cfg = alphazero.AZConfig(search="gumbel_lm", num_envs=6, num_sims=5, segment_len=3,
                             batch_size=8, updates_per_iter=2, model="conv", channels=8,
                             blocks=1)
    gen = torch.Generator()
    gen.manual_seed(2)
    st = alphazero.init_alphazero(cfg, gen)
    return cfg, lambda: alphazero.make_train_iteration(cfg)(st, gen)


def test_spans_nest(table):
    cfg, step = tiny_iteration()
    with profile(activities=[ProfilerActivity.CPU]):
        step()
    got = profiling.span_table()
    assert got["roots"] == 1
    assert {name for name, _ in table.edges} == set(PARENTS)
    for name, parent in table.edges:
        assert parent in PARENTS[name], (name, parent)
    spans = got["spans"]
    L, S = cfg.segment_len, cfg.num_sims
    assert spans["az.search"]["calls"] == spans["az.step"]["calls"] == L
    assert spans["az.descend"]["calls"] == spans["az.expand"]["calls"] == L * S
    assert spans["az.net"]["calls"] == L * (S + 1)
    assert spans["az.wins"]["calls"] == L * (S + 1)
    assert got["counters"]["az.searches"] == L
    assert got["counters"]["az.net_rows"] == L * (S + 1) * cfg.num_envs


def expected_counters(ref: dict, B: int) -> dict:
    """The search's counters from the reference's walk: at simulation
    ``s`` (``trips = min(s, 40)``) the descent runs ``min(d + 1, trips)``
    steps and syncs ``min(d + 1, trips - 1)`` times, ``d`` the most steps a
    root went down; the backup syncs ``min(D, trips)`` times, ``D`` the
    deepest start of a backup."""
    out = {"az.descend_trips": 0, "az.backup_trips": 0, "az.lane_steps": 0, "az.live_steps": 0}
    for s, (adv, depth) in enumerate(zip(ref["advances"], ref["depth"])):
        trips = min(s, az_search.MAX_DEPTH)
        d = int(adv.max())
        if trips:
            out["az.descend_trips"] += min(d + 1, trips - 1)
            out["az.lane_steps"] += B * min(d + 1, trips)
        out["az.live_steps"] += int(adv.sum())
        out["az.backup_trips"] += min(int(depth.max()), trips)
    return out


@pytest.mark.parametrize("B,sims", [(6, 8), (11, 20)])
def test_counters_of_a_tiny_search(table, B, sims):
    gen = torch.Generator()
    gen.manual_seed(sims)
    net = ac.ConvActorCritic(channels=16, blocks=1, dtype=torch.float32, device=CPU)
    net.reset_parameters(gen)
    params = {k: v.detach().clone() for k, v in net.state_dict().items()}
    board, current = (torch.from_numpy(x) for x in traffic.play_positions(sims, B, 40))
    noise = bc.gumbel_field(gen, (B, 54), CPU)
    cfg = gumbel.GumbelConfig(num_sims=sims, max_considered=16)
    with profile(activities=[ProfilerActivity.CPU]):
        _, _, _, visits, _ = gumbel_lm.gumbel_search_lm(
            net, board.permute(1, 2, 0).contiguous(), current, None, cfg,
            noise=noise.t().contiguous())
    counters = profiling.span_table()["counters"]
    ref = az_search.Search({"num_sims": sims, "max_considered": 16, "c_visit": cfg.c_visit,
                            "c_scale": cfg.c_scale}, az_search.evaluator(params), CPU
                           ).run(board, current, noise)
    assert (visits.numpy() == ref["visits"]).all()
    assert counters["az.searches"] == 1
    assert counters["az.net_rows"] == B * (sims + 1)
    for name, value in expected_counters(ref, B).items():
        assert counters[name] == value, name
    assert 0 < counters["az.live_steps"] < counters["az.lane_steps"]
    assert np.isclose(counters["az.live_steps"] / counters["az.lane_steps"],
                      ref["advances"].sum() / (counters["az.lane_steps"]))


def test_nothing_recorded_when_off(table):
    assert not profiling.enabled()
    assert profiling.annotate("az.search") is profiling._OFF
    _, step = tiny_iteration()
    step()
    got = profiling.span_table()
    assert got == {"roots": 0, "spans": {}, "counters": {}}
    assert table.edges == set()
