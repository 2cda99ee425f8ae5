"""Driver ``az_train``: the AlphaZero self-play iteration, back to back.

A closed loop: ``train/alphazero.py::make_train_iteration``'s iteration
(a segment of plies, each a Gumbel search over every root and a step of
the engine; the outcome backfill; the minibatched updates) runs again as
soon as the last one was issued.  One net plays both seats.

Set-up builds the state with ``alphazero.init_alphazero``, loads the
net's weights made from the seed, and drives it through the first
``check_iterations`` iterations by the window's own call.  Those
iterations are the warm-up (every shape of the window, and cuDNN's choice
of algorithms) and the ones the reference follows, read through the
segment's per-ply hook, the iteration's ``mark`` hook and the optimizer's
step hook: for ``check_envs`` roots a ply their boards, players, the
generator's state before the search, the search's outputs and the net's
logits; the checked lanes' rows of the segment; the minibatches (the
permutation redrawn from the generator's state at ``mark("outcomes")``);
the first step's gradient; the parameters at each iteration's start and
after the last.  The window then runs whole iterations until ``--seconds``
have passed, counts ``num_envs * segment_len`` env-steps an iteration,
and times them all.  After the window the program's state is freed and
the reference judges the checked iterations (:func:`judge`).

On the CPU (the harness's own tests; a run without a card prints no
result) the traffic's ``cpu_sizes`` replace the configuration's sizes.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from benchmark.harness import common, trace
from benchmark.reference import az as ref_az
from benchmark.reference import az_search, rules
from benchmark.reference import qnet as ref_qnet

ROWS = ("obs", "mask", "pi", "player", "done", "winner", "v_signed")


def config_fields(ctx) -> dict:
    """``AZConfig``'s fields: the configuration's, then the cell's."""
    fields = dict(ctx.config["az"])
    traffic = ctx.workload["traffic"]
    fields.update(traffic.get("az", {}))
    if ctx.device.type != "cuda":
        fields.update(traffic.get("cpu_sizes", {}))
    fields["hidden_sizes"] = tuple(fields["hidden_sizes"])
    return fields


def draw_weights(seed: int, fields: dict, device) -> dict:
    """The net's float32 weights from the seed: each convolution's
    ``[out, in, 3, 3]`` drawn as ``[out, in * 9]`` (fan-in ``in * 9``,
    flax's), biases zero."""
    shapes = ref_az.shapes(fields["channels"], fields["blocks"])
    flat = {k: (s[0], math.prod(s[1:])) if len(s) == 4 else s for k, s in shapes.items()}
    drawn = common.lecun_weights(seed, flat, device)
    return {k: drawn[k].view(shapes[k]) for k in shapes}


class Probe:
    """What the reference needs of the checked iterations, one dict an
    iteration in ``iterations``."""

    def __init__(self, cfg, st, generator, envs: np.ndarray):
        self.cfg, self.st, self.gen = cfg, st, generator
        self.envs = torch.from_numpy(envs).to(generator.device)
        self.names = {p: n for n, p in st.net.named_parameters()}
        self.iterations, self.cur, self.grad0 = [], None, None
        self._hook = st.optimizer.register_step_post_hook(self._first_step)

    def _first_step(self, optimizer, args, kwargs):
        beta1 = optimizer.param_groups[0]["betas"][0]
        self.grad0 = {self.names[p]: (optimizer.state[p]["exp_avg"] / (1 - beta1)).clone()
                      for p in self.names}
        self._hook.remove()

    def begin(self):
        params = {k: v.detach().clone() for k, v in self.st.net.state_dict().items()}
        self.cur = {"params": params, "plies": []}

    def ply(self, t, state, gen_state, out, traj):
        """The net runs on the whole ply as the search's root evaluation
        calls it (``gumbel_lm._evaluate_lm``), at the width and so with
        the kernels the window runs; the checked lanes are kept."""
        from gobblet_rl_torch.ops import batched_core as bc

        e = self.envs
        actions, pi, q, visits, root_v = out
        logits, value = self.st.net(bc.features_lm(state.board, state.current).t())
        logits, value = logits[e], value[e]
        self.cur["plies"].append({
            "board": state.board[:, :, e].permute(2, 0, 1).clone(),
            "current": state.current[e].clone(), "gen_state": gen_state,
            "action": actions[e].clone(), "pi": pi[e].clone(), "q": q[e].clone(),
            "visits": visits[e].clone(), "root_v": root_v[e].clone(), "logits": logits.clone(),
            "value": value.clone()})
        self.cur["traj"] = traj

    def mark(self, phase):
        if phase == "outcomes":   # the permutation is the generator's next draw
            self.cur["perm_state"] = self.gen.get_state()

    def after(self, stats):
        """Keep the checked lanes' rows and the minibatches' rows, with
        their value targets by the reference's backfill."""
        cfg, cur = self.cfg, self.cur
        traj = cur.pop("traj")
        L, B, U = cfg.segment_len, cfg.num_envs, cfg.updates_per_iter
        dev = traj["done"].device
        cur["rows"] = {k: traj[k][:, self.envs].clone() for k in ROWS}
        n = L * B
        mb = max(1, min(cfg.batch_size, n // max(U, 1)))
        g = torch.Generator(device=dev)
        g.set_state(cur.pop("perm_state"))
        perm = torch.randperm(n, generator=g, device=dev)
        idx = torch.cat([perm[(i * mb) % max(n - mb, 1):][:mb] for i in range(U)])
        t, b = idx // B, idx % B
        boot = traj["v_signed"][-1, b] if cfg.bootstrap_unfinished else None
        z, valid = ref_az.backfill(traj["done"][:, b], traj["winner"][:, b],
                                   traj["player"][:, b], boot)
        col = torch.arange(idx.shape[0], device=dev)
        cur["batch"] = {"obs": traj["obs"][t, b].to(torch.float32), "mask": traj["mask"][t, b],
                        "pi": traj["pi"][t, b].clone(), "z": z[t, col], "valid": valid[t, col]}
        cur["mb"], cur["loss"] = mb, float(stats["loss"])
        self.iterations.append(cur)
        self.cur = None


def setup(ctx) -> dict:
    """The state, driven through the checked iterations; what the window
    and the reference need of them."""
    from gobblet_rl_torch.train import alphazero

    common.setup_mark(ctx, "program imported")
    fields = config_fields(ctx)
    cfg = alphazero.AZConfig(**fields)
    dev = ctx.device
    traffic = ctx.workload["traffic"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(ctx.seed)
    st = alphazero.init_alphazero(cfg, gen)
    weights = draw_weights(ctx.seed, fields, dev)
    st.net.load_state_dict(weights)
    iteration = alphazero.make_train_iteration(cfg)
    common.setup_mark(ctx, "state built")

    rng = np.random.default_rng(ctx.seed)
    envs = np.sort(rng.choice(cfg.num_envs, size=min(traffic["check_envs"], cfg.num_envs),
                              replace=False))
    probe = Probe(cfg, st, gen, envs)
    for _ in range(traffic["check_iterations"]):
        probe.begin()
        stats = iteration(st, gen, mark=probe.mark, ply=probe.ply)
        probe.after(stats)
    common.setup_mark(ctx, f"{traffic['check_iterations']} checked iterations run")
    params_after = {k: v.detach().clone() for k, v in st.net.state_dict().items()}
    common.sync(dev)
    return {"fields": fields, "cfg": cfg, "gen": gen, "weights": weights, "st": st,
            "iteration": iteration, "probe": probe, "params_after": params_after}


def run(ctx) -> dict:
    s = setup(ctx)
    cfg, dev = s["cfg"], ctx.device
    st, iteration, gen = s.pop("st"), s.pop("iteration"), s["gen"]

    # the window: whole iterations until --seconds have passed
    setup_s = time.perf_counter() - ctx.started
    t0 = time.perf_counter()
    iters, ends = 0, []
    while True:
        iteration(st, gen)
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
        "env_steps": cfg.num_envs * cfg.segment_len * iters,
        "flops_per_iter": ctx.flops.per_iteration(s["fields"]),
        "net_flops_per_row": ctx.flops.forward_per_row(s["fields"]),
        "peak_flops": common.peak_flops(dev),
    }
    if ctx.trace:
        t_trace = time.perf_counter()
        data["trace"] = trace.profiled(lambda: iteration(st, gen), dev)
        common.log(f"traced iteration and its reduction: {time.perf_counter() - t_trace:.1f} s")
    data["memory_peak_bytes"] = common.memory_peak(dev)

    del st, iteration
    gc.collect()
    common.empty_cache(dev)
    t_judge = time.perf_counter()
    data["checks"] = judge(ctx, cfg, s["weights"], s["probe"], s["params_after"])
    common.log(f"judged in {time.perf_counter() - t_judge:.1f} s")
    data["attempted"], data["failed"] = iters, 0
    return data


# ---------------------------------------------------------------------------
# the judgement
# ---------------------------------------------------------------------------
def bad_rows(probe) -> tuple:
    """The checked (lane, ply) rows with any fault, and the faults by kind:
    the segment's obs, mask, player, done and winner rows against the
    rules at the recorded root; the played action legal; the pi and
    v_signed rows equal to the search's outputs; the next ply's root (or
    the first ply of the next iteration) the rules' successor, a fresh
    board where the game ended; the first root a fresh board."""
    kinds = {}
    total = 0
    prev = None
    for it in probe.iterations:
        rows = it["rows"]
        for t, ply in enumerate(it["plies"]):
            b, c = ply["board"], ply["current"]
            n = c.shape[0]
            legal = rules.legal_mask(b, c)
            a = ply["action"].to(torch.int64)
            nb = rules.apply(b, c, a)
            w = rules.winner(nb)
            if prev is None:
                prev = (torch.zeros_like(b), torch.zeros_like(c))
            faults = {
                "obs": (rows["obs"][t].to(torch.float32) != rules.features(b, c)).any(1),
                "mask": (rows["mask"][t] != legal).any(1),
                "player": rows["player"][t] != c,
                "illegal_action": ~legal.gather(1, a[:, None])[:, 0],
                "done": rows["done"][t] != (w != 0),
                "winner": rows["winner"][t] != w,
                "pi": (rows["pi"][t] != ply["pi"]).any(1),
                "v_signed": rows["v_signed"][t] != ply["root_v"] * torch.where(c == 0, 1.0, -1.0),
                "chain": (prev[0] != b).flatten(1).any(1) | (prev[1] != c),
            }
            bad = torch.zeros(n, dtype=torch.bool, device=c.device)
            for k, f in faults.items():
                kinds[k] = kinds.get(k, 0) + int(f.sum())
                bad |= f
            total += int(bad.sum())
            ended = (w != 0)
            prev = (torch.where(ended[:, None, None], torch.zeros_like(nb), nb),
                    torch.where(ended, 0, 1 - c).to(c.dtype))
    return total, kinds


def net_gap(probe, quant=None) -> float:
    """The widest gap of the recorded logits and value from the reference
    net's (float32, or through ``quant``: the control) on the checked
    roots, over the row's largest reference |logit|."""
    worst = 0.0
    for it in probe.iterations:
        for ply in it["plies"]:
            obs = rules.features(ply["board"], ply["current"])
            logits, value = ref_az.forward(it["params"], obs)
            if quant is None:
                got_l, got_v = ply["logits"], ply["value"]
            else:
                got_l, got_v = ref_az.forward(it["params"], obs, quant)
            gap = torch.maximum((got_l - logits).abs().amax(1), (got_v - value).abs())
            worst = max(worst, float((gap / logits.abs().amax(1)).max()))
    return worst


def root_noise(ply, num_envs: int, envs: torch.Tensor) -> torch.Tensor:
    """float32[n, 54]: the search's root Gumbel field at the checked lanes,
    redrawn from the generator's state before the search."""
    g = torch.Generator(device=envs.device)
    g.set_state(ply["gen_state"])
    u = torch.rand((54, num_envs), generator=g, device=envs.device)
    u.clamp_(min=torch.finfo(torch.float32).tiny)
    return (-torch.log(-torch.log(u)))[:, envs].t()


def search_config(ctx, cfg) -> dict:
    return {"num_sims": cfg.num_sims, "max_considered": cfg.max_considered,
            **ctx.config["gumbel"]}


def reference_search(ctx, cfg, probe, quant, **fault) -> dict:
    """The reference search over the last checked iteration's roots, with
    its net through ``quant``."""
    it = probe.iterations[-1]
    board = torch.cat([p["board"] for p in it["plies"]])
    player = torch.cat([p["current"] for p in it["plies"]])
    noise = torch.cat([root_noise(p, cfg.num_envs, probe.envs) for p in it["plies"]])
    search = az_search.Search(search_config(ctx, cfg), az_search.evaluator(it["params"], quant),
                              ctx.device, **fault)
    return search.run(board, player, noise)


def program_search(probe) -> dict:
    it = probe.iterations[-1]
    got = {k: torch.cat([p[src] for p in it["plies"]]).cpu().numpy()
           for k, src in (("action", "action"), ("visits", "visits"), ("q", "q"), ("pi", "pi"),
                          ("value", "root_v"))}
    got["q"] = np.where(got["visits"] > 0, got["q"], np.float32(0))
    return got


def search_gaps(got: dict, ref: dict) -> dict:
    """Against the reference search ``ref``: ``visit_mismatch``, the share
    of roots whose 54 visit counts or played action differ; on the roots
    that match, the median over the roots of the widest gap of the
    improved-policy target (``pi_gap_search``) and of the root value
    (``value_gap_search``), and their widest (``pi_gap_search_max``,
    ``value_gap_search_max``).  The widest is set by roots whose walks
    below the root parted on a logit one bfloat16 step apart: their
    visits at the root agree and their children's mean values do not
    (``q_gap_at_pi_max``, the widest gap of the root's Q at the root of the
    widest target gap).  Where no root matches, the largest gaps possible."""
    same = (got["visits"] == ref["visits"]).all(1) & (got["action"] == ref["action"])
    if not same.any():
        return {"visit_mismatch": 1.0, "pi_gap_search": 1.0, "value_gap_search": 2.0,
                "pi_gap_search_max": 1.0, "value_gap_search_max": 2.0, "q_gap_at_pi_max": 2.0}
    pi = np.abs(got["pi"] - ref["pi"]).max(1)[same]
    value = np.abs(got["value"] - ref["value"])[same]
    q = np.abs(got["q"] - ref["q"]).max(1)[same]
    return {"visit_mismatch": float(1.0 - same.mean()),
            "pi_gap_search": float(np.median(pi)), "value_gap_search": float(np.median(value)),
            "pi_gap_search_max": float(pi.max()), "value_gap_search_max": float(value.max()),
            "q_gap_at_pi_max": float(q[pi.argmax()])}


def won_child(ply) -> torch.Tensor:
    """bool[n]: the roots with a visited action whose every visit returned
    a win for the root's player (a minority of the roots)."""
    return ((ply["visits"] > 0) & (ply["q"] >= 0.999)).any(1)


def flatten_won(ply) -> torch.Tensor:
    """A planted fault: the target flattened (its square root, normalised)
    at the roots with a won child."""
    pi = ply["pi"]
    flat = pi.sqrt() / pi.sqrt().sum(1, keepdim=True)
    return torch.where(won_child(ply)[:, None], flat, pi)


def target_gaps(ctx, cfg, probe, got_pi=lambda ply: ply["pi"], unvalued_wins=False) -> dict:
    """``pi_gap`` and ``value_gap``: over every checked root, the widest gap
    of the program's improved-policy target and root value from the
    reference's (:meth:`az_search.Search.target`, the root's immediate win
    valued 1) on the program's own root: its visits and mean values, and
    the priors and value of the net's logits there.  What the walks below
    the root did does not enter, so every root is held.  ``won_share``:
    the share of roots with a won child (:func:`flatten_won`'s);
    ``win_share``: of roots with an immediate win.  ``unvalued_wins``
    plants a fault: the program's root value replaced by the mixed value
    where the root's player can win at once."""
    search = az_search.Search(search_config(ctx, cfg), None, ctx.device)
    pi_gap = value_gap = 0.0
    won = win = roots = 0
    for it in probe.iterations:
        for ply in it["plies"]:
            board, current = ply["board"], ply["current"]
            legal = rules.legal_mask(board, current)
            P = ref_az.priors(ply["logits"], legal).cpu().numpy()
            v = torch.tanh(ply["value"]).cpu().numpy()
            wins = az_search.immediate_wins(board, current, legal).any(1)
            n = ply["visits"].cpu().numpy()
            q = np.where(n > 0, ply["q"].cpu().numpy(), np.float32(0))
            pi, root_v = got_pi(ply).cpu().numpy(), ply["root_v"].cpu().numpy()
            legal = legal.cpu().numpy()
            for r in range(n.shape[0]):
                ref_pi, v_mix = search.target(P[r], legal[r], v[r], n[r], q[r])
                ref_v = 1.0 if wins[r] else float(v_mix)
                got_v = float(v_mix) if unvalued_wins and wins[r] else float(root_v[r])
                pi_gap = max(pi_gap, float(np.abs(pi[r] - ref_pi).max()))
                value_gap = max(value_gap, abs(got_v - ref_v))
            won += int(won_child(ply).sum())
            win += int(wins.sum())
            roots += n.shape[0]
    return {"pi_gap": pi_gap, "value_gap": value_gap, "won_share": won / roots,
            "win_share": win / roots}


def reference_config(ctx, cfg) -> dict:
    adamw = ctx.config["adamw"]
    return {"lr": cfg.lr, "betas": tuple(adamw["betas"]), "eps": adamw["eps"],
            "weight_decay": cfg.weight_decay, "max_grad_norm": cfg.max_grad_norm,
            "value_coef": cfg.value_coef}


def minibatches(cfg, probe) -> list:
    """Per checked iteration, its minibatches as the reference's rows."""
    out = []
    for it in probe.iterations:
        mb = it["mb"]
        out.append([{k: v[u * mb:(u + 1) * mb] for k, v in it["batch"].items()}
                    for u in range(cfg.updates_per_iter)])
    return out


def learner_gaps(ctx, cfg, weights, probe, params_after, quant=None, rows=None) -> dict:
    """``loss_gap``, ``change_gap``, ``grad_excess`` and ``grad_gap`` as the
    DQN cells define them (``dqn_train.gaps``), of the program's learner,
    or of the reference through ``quant`` or over ``rows`` only (the
    control, the half-batch fault)."""
    dqn_train = common.load_module(common.BENCH_DIR / "drivers" / "dqn_train.py",
                                   "bench_driver_dqn_train")
    batches = minibatches(cfg, probe)
    rcfg = reference_config(ctx, cfg)
    ref = ref_az.train(weights, batches, rcfg)
    yard = ref_az.first_gradient(weights, batches[0][0], rcfg, quant=ref_qnet.bf16)
    if quant is None and rows is None:
        got = ([it["loss"] for it in probe.iterations], probe.grad0, params_after)
    else:
        got = ref_az.train(weights, batches, rcfg, quant=quant, rows=rows)
    return dqn_train.gaps(*got, ref, weights, yard)


def judge(ctx, cfg, weights, probe, params_after) -> list:
    """``[name, value, limit]`` of each number that the cell's workload
    file gives a limit; the other numbers are printed, not compared."""
    limits = ctx.workload["limits"]
    with ref_qnet.exact_float32():
        numbers = {}
        numbers["bad_rows"], kinds = bad_rows(probe)
        numbers["net_gap"] = net_gap(probe)
        numbers.update(target_gaps(ctx, cfg, probe))
        numbers.update(search_gaps(program_search(probe),
                                   reference_search(ctx, cfg, probe, ref_qnet.bf16)))
        g = learner_gaps(ctx, cfg, weights, probe, params_after)
    numbers.update({k: g[k] for k in ("loss_gap", "change_gap", "grad_excess", "grad_gap")})
    shown = {k: v for k, v in numbers.items() if k not in limits}
    common.log(f"row faults by kind: {kinds}; leaves left out: {g['leaves_left_out']}; "
               f"not compared: {shown}")
    return [[name, numbers[name], limit] for name, limit in limits.items()]
