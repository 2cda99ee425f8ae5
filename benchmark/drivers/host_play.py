"""Driver ``host_play``: one player asking a zoo agent for moves at B=1.

A closed loop: ``zoo.host_agent(name).compute_action(obs, mask)`` is
called on the next position as soon as it has returned, with the (3, 3,
13) observation and the mask the host env would hand it.  The agent's
weights are made from the seed and written with the program's
``zoo.save`` into a zoo of the run's own (under ``$TMPDIR``), which
``$GOBBLET_ZOO_DIR`` names; the agent loads them from there.

The positions come from ``harness/traffic.py`` in set-up and are replayed
in order, round and round, for ``--seconds``; a move is timed on the
host's clock from the call to the returned action (the agent ends in a
host integer, so the device has finished).  After the window, every move
of the window is judged: the reference computes the Q-values of its
position in float32 and reads how far the played move's value lies below
the best legal one.
"""

from __future__ import annotations

import gc
import os
import time
from pathlib import Path

import numpy as np
import torch

from benchmark.harness import common, trace, traffic
from benchmark.reference import qnet as ref_qnet
from benchmark.reference import rules


def zoo_dir() -> Path:
    base = os.environ.get("TMPDIR") or str(common.ROOT / ".bench_cache")
    return Path(base) / "benchmark_zoo"


def setup(ctx) -> dict:
    from gobblet_rl_torch import zoo
    from gobblet_rl_torch.models.mlp import QNet

    common.setup_mark(ctx, "program imported")
    cfg, tr, dev = ctx.config["dqn"], ctx.workload["traffic"], ctx.device
    hidden, dueling = tuple(cfg["hidden_sizes"]), cfg["dueling"]
    weights = common.lecun_weights(ctx.seed, common.qnet_shapes(hidden, dueling), dev)
    net = QNet(hidden_sizes=hidden, dueling=dueling, device=dev)
    net.load_state_dict(weights)
    os.environ["GOBBLET_ZOO_DIR"] = str(zoo_dir())
    zoo.save(tr["agent"], net, {"family": "dqn",
                                "net": {"hidden_sizes": list(hidden), "dueling": dueling}})
    del net
    agent = zoo.host_agent(tr["agent"], seed=ctx.seed, device=dev)
    common.setup_mark(ctx, "agent saved and loaded")
    board, current = traffic.play_positions(ctx.seed, tr["positions"], tr["max_plies"])
    obs = rules.observation(torch.from_numpy(board), torch.from_numpy(current)).numpy()
    mask = rules.legal_mask(torch.from_numpy(board), torch.from_numpy(current)).numpy()
    mask = mask.astype(np.int8)
    common.setup_mark(ctx, "positions made")
    for i in range(tr["warmup_moves"]):
        agent.compute_action(obs[i % len(obs)], mask[i % len(obs)])
    common.sync(dev)
    return {"agent": agent, "board": board, "current": current, "obs": obs, "mask": mask,
            "weights": weights}


def run(ctx) -> dict:
    s = setup(ctx)
    agent, obs, mask, dev = s["agent"], s["obs"], s["mask"], ctx.device
    n = len(obs)
    played, move_ms = [], []
    setup_s = time.perf_counter() - ctx.started
    t0 = time.perf_counter()
    i = 0
    while True:
        a = time.perf_counter()
        action = agent.compute_action(obs[i % n], mask[i % n])
        move_ms.append((time.perf_counter() - a) * 1e3)
        played.append(action)
        i += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    window_s = time.perf_counter() - t0
    data = {"setup_s": setup_s, "window_s": window_s, "move_ms": move_ms}
    if ctx.trace:
        data["policy_ms"] = policy_ms(ctx, s)
        k = ctx.workload["traffic"]["profile_moves"]

        def moves():
            for j in range(k):
                with torch.profiler.record_function(f"{trace.SPAN_PREFIX}play.move"):
                    agent.compute_action(obs[j % n], mask[j % n])

        data["trace"] = trace.profiled(moves, dev)
    data["memory_peak_bytes"] = common.memory_peak(dev)
    del agent, s["agent"]
    gc.collect()
    common.empty_cache(dev)
    data["checks"], bad = judge(ctx, s, np.asarray(played))
    data["attempted"], data["failed"] = len(played), bad
    return data


def policy_ms(ctx, s) -> list:
    """The zoo policy alone at B=1 (no observation decode): host ms from
    the call to its action as a host integer, over the traffic's first
    ``policy_moves`` positions, each board already on the device."""
    from gobblet_rl_torch import zoo

    dev, tr = ctx.device, ctx.workload["traffic"]
    pol = zoo.policy(tr["agent"], device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(ctx.seed)
    k = min(tr["policy_moves"], len(s["board"]))
    boards = [torch.from_numpy(s["board"][j]).to(dev)[..., None] for j in range(k)]
    currents = [torch.tensor([int(s["current"][j])], dtype=torch.int32, device=dev)
                for j in range(k)]
    for j in range(min(k, tr["warmup_moves"])):
        int(pol(gen, boards[j], currents[j])[0])
    out = []
    for j in range(k):
        t = time.perf_counter()
        int(pol(gen, boards[j], currents[j])[0])
        out.append((time.perf_counter() - t) * 1e3)
    return out


def reference_q(weights, board, current, quant=None) -> torch.Tensor:
    """float32[N, 54] Q-values of the positions, illegal moves at -inf."""
    b = torch.from_numpy(board).to(next(iter(weights.values())).device)
    c = torch.from_numpy(current).to(b.device)
    with ref_qnet.exact_float32():
        q = ref_qnet.forward(weights, rules.features(b, c), quant)
    return q.masked_fill(~rules.legal_mask(b, c), -torch.inf)


def widest_gap(q: torch.Tensor, chosen: torch.Tensor):
    """(the widest gap of a chosen move's value below the best legal one,
    over the largest magnitude of a legal move's value; the count of
    illegal moves)."""
    best = q.max(1).values
    got = q.gather(1, chosen[:, None].long())[:, 0]
    illegal = torch.isinf(got)
    scale = q.masked_fill(torch.isinf(q), 0.0).abs().max(1).values.clamp(min=1e-12)
    gap = ((best - got) / scale).masked_fill(illegal, 0.0)
    return float(gap.max()), int(illegal.sum())


def judge(ctx, s, played: np.ndarray):
    """Every move of the window: ``([name, value, limit], illegal)``."""
    limits = ctx.workload["limits"]
    n = len(s["obs"])
    idx = np.arange(len(played)) % n
    q = reference_q(s["weights"], s["board"][idx], s["current"][idx])
    gap, illegal = widest_gap(q, torch.from_numpy(played).to(q.device))
    return [["q_gap", gap, limits["q_gap"]],
            ["illegal_moves", illegal, limits["illegal_moves"]]], illegal
