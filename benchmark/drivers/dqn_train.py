"""Driver ``dqn_train``: the DQN actor-learner iteration, back to back.

A closed loop: ``train/dqn.py::make_train_iteration``'s iteration
(collect against the opponent, fold and insert into the ring, one sample,
the updates) runs again as soon as the last one was issued.

Set-up builds the train state, the env batch and the ring once, with the
Q-net's weights made from the seed, and drives them through the first
``check_steps`` iterations by the window's own call.  Those iterations
are the warm-up (every shape of the window) and the ones the reference
follows: it reads their ring rows, the sampled minibatches (redrawn from
the generator's state at the sample), the first step's gradient (from
Adam's state after it) and the parameters after the last.  The window
then runs whole iterations until ``--seconds`` have passed, counts
``num_envs * (segment_len + n_step - 1)`` env-steps an iteration, and
times them all.  After the window the program's state is freed and the
reference judges the checked iterations (``judge``).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark.harness import common, trace
from benchmark.reference import qnet as ref_qnet
from benchmark.reference import rules, transitions

RING_FIELDS = ("board", "current", "action", "reward_n", "done_n", "board_n", "current_n")
PHASES = ["collect", "insert", "sample", "updates"]


def config_fields(ctx) -> dict:
    """``DQNConfig``'s fields: the configuration's, then the cell's."""
    fields = dict(ctx.config["dqn"])
    fields.update(ctx.workload["traffic"].get("dqn", {}))
    fields["hidden_sizes"] = tuple(fields["hidden_sizes"])
    fields["mixed_weights"] = tuple(fields["mixed_weights"])
    return fields


class Probe:
    """What the reference needs of the checked iterations, read through the
    iteration's ``mark`` hook, the optimizer's step hook and the ring."""

    def __init__(self, cfg, ts, generator, envs: np.ndarray):
        self.cfg, self.gen = cfg, generator
        self.envs = torch.from_numpy(envs).to(generator.device)
        self.names = {p: n for n, p in ts.net.named_parameters()}
        self.gen_state = None
        self.rows, self.batches, self.losses = [], [], []
        self.grad0 = None
        self._hook = ts.optimizer.register_step_post_hook(self._first_step)

    def _first_step(self, optimizer, args, kwargs):
        beta1 = optimizer.param_groups[0]["betas"][0]
        self.grad0 = {self.names[p]: (optimizer.state[p]["exp_avg"] / (1 - beta1)).clone()
                      for p in self.names}
        self._hook.remove()

    def mark(self, phase):
        if phase == "insert":   # the sample is the generator's next draw
            self.gen_state = self.gen.get_state()

    def after(self, buffer, cursor: int, filled: int, loss):
        cfg = self.cfg
        S, B, cap = cfg.segment_len, cfg.num_envs, buffer.board.shape[0]
        count = S * B
        if count > cap:
            raise ValueError("the probe reads an iteration's rows from the ring, "
                             "which must hold them all")
        dev = buffer.board.device
        k = (torch.arange(S, device=dev)[:, None] * B + self.envs[None]).reshape(-1)
        pos = k if count == cap else (cursor + k) % cap
        self.rows.append({f: getattr(buffer, f)[pos].view(S, len(self.envs), -1).squeeze(-1)
                          .clone() for f in RING_FIELDS})
        g = torch.Generator(device=dev)
        g.set_state(self.gen_state)
        n = cfg.update_per_collect * cfg.batch_size
        idx = torch.randint(0, max(min(filled + count, cap), 1), (n,), generator=g, device=dev)
        self.batches.append({f: getattr(buffer, f)[idx].clone() for f in RING_FIELDS})
        self.losses.append(loss.detach().clone())


def setup(ctx) -> dict:
    """The train state, env batch and ring, driven through the checked
    iterations; what the window and the reference need of them."""
    from gobblet_rl_torch.train import dqn, replay

    common.setup_mark(ctx, "program imported")
    fields = config_fields(ctx)
    cfg = dqn.DQNConfig(**fields)
    dev = ctx.device
    traffic = ctx.workload["traffic"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(ctx.seed)
    weights = common.lecun_weights(ctx.seed, common.qnet_shapes(cfg.hidden_sizes, cfg.dueling),
                                   dev)
    ts = dqn.init_train_state(cfg, dqn.make_net(cfg, dev), gen)
    for net in (ts.net, ts.target_net, ts.opponent_net):
        net.load_state_dict(weights)
    iteration, opponent_fn = dqn.make_train_iteration(cfg)
    env = dqn.init_env_state(cfg, opponent_fn, ts.opponent_net, gen)
    buf = replay.make_buffer(cfg.buffer_size, dev)
    common.setup_mark(ctx, "train state, env batch and ring built")

    rng = np.random.default_rng(ctx.seed)
    envs = np.sort(rng.choice(cfg.num_envs, size=min(traffic["check_envs"], cfg.num_envs),
                              replace=False))
    probe = Probe(cfg, ts, gen, envs)
    start = (env.board[:, :, probe.envs].permute(2, 0, 1).clone(), env.current[probe.envs].clone())
    for _ in range(traffic["check_steps"]):
        cursor, filled = buf.cursor, buf.filled
        env, buf, loss = iteration(ts, env, buf, gen, mark=probe.mark)
        probe.after(buf, cursor, filled, loss)
    common.setup_mark(ctx, f"{traffic['check_steps']} checked iterations issued")
    params_after = {k: v.detach().clone() for k, v in ts.net.state_dict().items()}
    common.sync(dev)
    return {"fields": fields, "cfg": cfg, "gen": gen, "weights": weights, "ts": ts,
            "iteration": iteration, "env": env, "buf": buf, "probe": probe, "start": start,
            "params_after": params_after}


def run(ctx) -> dict:
    s = setup(ctx)
    cfg, dev, gen, ts, iteration = s["cfg"], ctx.device, s["gen"], s["ts"], s["iteration"]
    state = {"env": s.pop("env"), "buf": s.pop("buf")}

    def step(mark=None):
        state["env"], state["buf"], _ = iteration(ts, state["env"], state["buf"], gen, mark=mark)

    # the window: whole iterations until --seconds have passed
    stamps = [] if ctx.trace else None
    setup_s = time.perf_counter() - ctx.started
    t0 = time.perf_counter()
    iters, ends = 0, []
    while True:
        if stamps is None:
            step()
        else:
            marks = {"start": common.Stamp(dev)}
            stamps.append(marks)
            step(lambda phase, marks=marks: marks.__setitem__(phase, common.Stamp(dev)))
        iters += 1
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= ctx.seconds:
            break
    common.sync(dev)
    window_s = time.perf_counter() - t0
    issued = np.diff([0.0] + ends)
    common.log(f"window: host seconds to issue an iteration: min {issued.min():.4f}, "
               f"median {np.median(issued):.4f}, max {issued.max():.4f}")
    data = {
        "setup_s": setup_s,
        "window_s": window_s,
        "iterations": iters,
        "env_steps": cfg.num_envs * (cfg.segment_len + cfg.n_step - 1) * iters,
        "flops_per_iter": ctx.flops.per_iteration(s["fields"]),
        "peak_flops": common.peak_flops(dev),
    }
    if stamps is not None:
        data["phase_ms"] = {
            "collect": [m["start"].ms_to(m["collect"]) for m in stamps],
            "learn": [m["collect"].ms_to(m["updates"]) for m in stamps],
        }
        spans = trace.PhaseSpans("dqn", PHASES)

        def traced():
            spans.begin()
            step(spans.mark)

        data["trace"] = trace.profiled(traced, dev)
    data["memory_peak_bytes"] = common.memory_peak(dev)

    del ts, iteration, state, step, s["ts"], s["iteration"]
    gc.collect()
    common.empty_cache(dev)
    data["checks"] = judge(ctx, cfg, s["weights"], s["probe"], s["start"], s["params_after"])
    data["attempted"], data["failed"] = iters, 0
    return data


def _features(rows):
    board = rows["board"].view(-1, 3, 9)
    board_n = rows["board_n"].view(-1, 3, 9)
    cur = rows["current"].to(torch.int32)
    cur_n = rows["current_n"].to(torch.int32)
    return {
        "obs": rules.features(board, cur),
        "obs_n": rules.features(board_n, cur_n),
        "mask_n": rules.legal_mask(board_n, cur_n),
        "action": rows["action"],
        "reward_n": rows["reward_n"],
        "done_n": rows["done_n"],
    }


def minibatches(cfg, probe) -> list:
    """Per checked iteration, its minibatches as the reference's features."""
    out = []
    for raw in probe.batches:
        feats = _features(raw)
        bs = cfg.batch_size
        out.append([{k: v[u * bs:(u + 1) * bs] for k, v in feats.items()}
                    for u in range(cfg.update_per_collect)])
    return out


def reference_config(ctx, cfg) -> dict:
    adam = ctx.config["adam"]
    return {"lr": cfg.lr, "betas": tuple(adam["betas"]), "eps": adam["eps"], "gamma": cfg.gamma,
            "n_step": cfg.n_step, "double": cfg.double,
            "target_update_freq": cfg.target_update_freq}


def gaps(losses, grad0, params, ref, params0, yard) -> dict:
    """The numbers of a run against the reference ``ref`` =
    ``(losses, grad0, params)``: the widest relative loss gap over the
    checked iterations; by leaf the gap between the norms of the first
    gradient and of the parameters' change, each over the larger of the
    reference leaf's norm and the median leaf's, the worst leaf taken; and
    ``grad_excess``, the whole first gradient's distance from the
    reference's in units of the distance of ``yard``, the reference's first
    gradient with its matmul operands rounded through bfloat16 (the
    configuration's precision).  Leaves whose reference gradient is under
    a thousandth of the median leaf's are left out."""
    r_losses, r_grad0, r_params = ref
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses))
    gnorm = {k: float(g.norm()) for k, g in r_grad0.items()}
    med_g = float(np.median(list(gnorm.values())))
    keep = [k for k in r_grad0 if gnorm[k] >= 1e-3 * med_g]
    grad_gap = max(abs(float(grad0[k].norm()) - gnorm[k]) / max(gnorm[k], med_g)
                   for k in keep)
    grad_excess = (sum(float((grad0[k] - r_grad0[k]).norm()) ** 2 for k in keep)
                   / sum(float((yard[k] - r_grad0[k]).norm()) ** 2 for k in keep)) ** 0.5
    dref = {k: float((r_params[k] - params0[k]).norm()) for k in keep}
    med_d = float(np.median(list(dref.values())))
    change_gap = max(abs(float((params[k] - params0[k]).norm()) - dref[k]) / max(dref[k], med_d)
                     for k in keep)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "grad_excess": grad_excess,
            "change_gap": change_gap, "leaves_left_out": len(r_grad0) - len(keep)}


def transition_faults(cfg, probe, start) -> dict:
    seats = learner_seats(cfg, probe.envs)
    kind, depth = cfg.opponent, cfg.greedy_depth
    total = {"start": transitions.check_start(start[0], start[1], seats, kind, depth),
             "chain": 0}
    prev = start
    for rows in probe.rows:
        faults, first_b, last_b, first_c, last_c = transitions.check_iteration(
            rows, seats, kind, depth, cfg.n_step, cfg.gamma)
        for k, v in faults.items():
            total[k] = total.get(k, 0) + v
        total["chain"] += int(((prev[0] != first_b).flatten(1).any(1)
                               | (prev[1].to(torch.int32) != first_c)).sum())
        prev = (last_b, last_c)
    return total


def learner_seats(cfg, envs):
    if cfg.learner_player == "both":
        return (envs % 2).to(torch.int32)
    return torch.full_like(envs, int(cfg.learner_player), dtype=torch.int32)


def judge(ctx, cfg, weights, probe, start, params_after) -> list:
    """``[name, value, limit]`` of each number that the cell's workload
    file gives a limit; the other numbers are printed, not compared."""
    limits = ctx.workload["limits"]
    with ref_qnet.exact_float32():
        batches = minibatches(cfg, probe)
        rcfg = reference_config(ctx, cfg)
        ref = ref_qnet.train(weights, batches, rcfg)
        yard = ref_qnet.first_gradient(weights, batches[0][0], rcfg, quant=ref_qnet.bf16)
        losses = [float(x) for x in probe.losses]
        g = gaps(losses, probe.grad0, params_after, ref, weights, yard)
        faults = transition_faults(cfg, probe, start)
    numbers = {k: g[k] for k in ("loss_gap", "change_gap", "grad_excess", "grad_gap")}
    numbers["bad_transitions"] = sum(faults.values())
    shown = {k: v for k, v in numbers.items() if k not in limits}
    common.log(f"transition faults by kind: {faults}; leaves left out: "
               f"{g['leaves_left_out']}; not compared: {shown}")
    return [[name, numbers[name], limit] for name, limit in limits.items()]
