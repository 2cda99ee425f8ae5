"""Headline benchmark of the port: the fused rollout and the training
iterations of every family, on the card.

Port of the repository's ``bench.py``.  It measures

1. the fused random-admissible rollout: the hand-written CUDA kernel
   (``kernels/rollout.py::rollout_random_fused``) over ``BATCH`` envs x
   ``STEPS`` plies, steady state on one state chain, the median of
   ``REPEATS`` calls after 2 warm-ups; the eager engine
   (``batched_core.rollout_random``) is timed beside it and goes to stderr;
2. one training iteration of each family, in bench.py's configurations:
   DQN (``train/dqn.py``, 2 warm-ups and 8 timed), AlphaZero
   (``train/alphazero.py``, 2 and 4) and PPO (``train/ppo.py``, 2 and 8);
3. FLOPs an iteration, counted by ``torch.utils.flop_counter.
   FlopCounterMode`` over the first warm-up iteration, and the MFU against
   the card's bf16 dense peak.

Every clock read follows ``torch.cuda.synchronize()``.  Auxiliary JSON
lines come first and the headline is the last line of stdout:

    {"metric": "env_steps_per_sec", "value": ..., "unit": ..., "vs_baseline": ...}

    python -m gobblet_rl_torch.scripts.bench
    GOBBLET_BENCH_ONLY=dqn,ppo python -m gobblet_rl_torch.scripts.bench
    GOBBLET_BENCH_DEVICE=cpu GOBBLET_BENCH_BATCH=512 ... python -m gobblet_rl_torch.scripts.bench

It reads bench.py's ``GOBBLET_BENCH_*`` variables with their defaults, and
``GOBBLET_BENCH_DEVICE`` (unset: the CUDA card, raising without one).
``GOBBLET_BENCH_TRAIN_PRNG`` has no counterpart: torch has one Philox
generator, so there is no second implementation to choose.

What differs from bench.py's lines:

* The train lines carry ``flop_counter_flops_per_iter`` where bench.py has
  ``xla_flops_per_iter``, and no ``xla_bytes_per_iter``,
  ``hbm_gbytes_per_sec`` or ``hbm_util``: torch has no compiled cost model
  for the bytes an iteration moves, and bench.py leaves its roofline
  fields out where XLA's model is unavailable.
* ``mfu`` and the rollout's ``hbm_*`` fields are against the peaks of the
  card they ran on (``PEAKS``), and ``null`` on a device without an entry
  there, the CPU included.
* The rollout's ``bytes_per_env_step`` is the kernel's own global traffic
  (``rollout.cu``: the board and the player read and written once a call,
  plus three int64 totals) over its env-steps; it does no floating-point
  work, so its FLOPs are 0.
* ``vs_baseline`` divides by a rate measured in the same process on the
  card's host: a random-admissible driver over the port's single-env
  ``board.Board`` for ``BASELINE_SECONDS``, printed with its definition
  on stderr.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from gobblet_rl_torch.device import resolve_device

# Dense peaks of a card (NVIDIA's H100 SXM data sheet, at its 700 W limit):
# bf16 tensor-core FLOP/s and HBM3 bytes/s, keyed by the name torch reports.
PEAKS = {"NVIDIA H100 80GB HBM3": (989e12, 3.35e12)}
BASELINE_SECONDS = 2.0
BASELINE = ("a random-admissible driver over gobblet_rl_torch.board.Board on the host: a step "
            "asks is_legal of all 54 actions, plays one drawn uniformly among the legal ones "
            "and checks the winner; a won game starts a fresh board")
WARMUP = 2
TIMED_ITERS = {"dqn": 8, "az": 4, "ppo": 8}


@dataclasses.dataclass(frozen=True)
class Settings:
    """bench.py's environment variables and defaults, plus the device."""

    batch: int = 524288
    steps: int = 64
    repeats: int = 5
    train_envs: int = 262144
    az_envs: int = 2048
    az_sims: int = 32
    az_segment: int = 48
    az_search: str = "gumbel_lm"
    ppo_envs: int = 8192
    ppo_segment: int = 32
    only: frozenset = frozenset()
    device: str | None = None

    @classmethod
    def from_env(cls, env=os.environ) -> Settings:
        kw = {}
        for f in dataclasses.fields(cls):
            raw = env.get(f"GOBBLET_BENCH_{f.name.upper()}")
            if raw is None:
                continue
            if f.name == "only":
                kw[f.name] = frozenset(filter(None, raw.split(",")))
            else:
                kw[f.name] = raw if f.default is None else type(f.default)(raw)
        return cls(**kw)

    def want(self, section: str) -> bool:
        return not self.only or section in self.only


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def count_flops(fn) -> int:
    """The FLOPs ``FlopCounterMode`` counts while ``fn()`` runs."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def peaks(dev: torch.device) -> tuple:
    """(bf16 FLOP/s, HBM bytes/s) of the card ``dev``, or (None, None)."""
    if dev.type != "cuda":
        return None, None
    return PEAKS.get(torch.cuda.get_device_name(dev), (None, None))


def roofline(result: dict, flops: int, calls_per_sec: float, dev: torch.device) -> dict:
    """Attach the counted FLOPs, the achieved rate and the MFU."""
    peak_flops, _ = peaks(dev)
    result["flop_counter_flops_per_iter"] = flops
    result["tflops_per_sec"] = round(flops * calls_per_sec / 1e12, 3)
    result["mfu"] = None if peak_flops is None else round(flops * calls_per_sec / peak_flops, 5)
    return result


def timed_iterations(step, iters: int, dev: torch.device) -> tuple[float, int]:
    """(seconds of ``iters`` timed calls of ``step``, the FLOPs of one):
    ``WARMUP`` untimed calls first, the first of them counted."""
    flops = count_flops(step)
    for _ in range(WARMUP - 1):
        step()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    sync(dev)
    return time.perf_counter() - t0, flops


# ---------------------------------------------------------------------------
# training iterations: bench.py's configurations and work counts
# ---------------------------------------------------------------------------
def dqn_config(s: Settings):
    from gobblet_rl_torch.train import dqn

    return dqn.DQNConfig(
        num_envs=s.train_envs,
        buffer_size=max(1 << 18, s.train_envs * 16),
        batch_size=min(4096, s.train_envs),
        segment_len=16,
        update_per_collect=8,
        opponent="random",
    )


def dqn_env_steps_per_iter(config) -> int:
    return config.num_envs * (config.segment_len + config.n_step - 1)


def az_config(s: Settings):
    from gobblet_rl_torch.train import alphazero

    return alphazero.AZConfig(
        search=s.az_search, num_sims=s.az_sims, num_envs=s.az_envs,
        segment_len=s.az_segment, model="conv",
        batch_size=min(2048, s.az_envs * s.az_segment),
    )


def az_moves_per_iter(config) -> int:
    return config.num_envs * config.segment_len


def ppo_config(s: Settings):
    from gobblet_rl_torch.train import ppo

    return ppo.PPOConfig(
        num_envs=s.ppo_envs, segment_len=s.ppo_segment, shared_policy=True,
        learner_player="both", opponent="self",
    )


def ppo_env_steps_per_iter(config) -> int:
    return config.num_envs * config.segment_len


def bench_dqn_train(s: Settings, dev: torch.device) -> dict:
    """The fused DQN actor-learner iteration, with the plain-headed ``QNet``
    bench.py builds."""
    from gobblet_rl_torch.models.mlp import QNet
    from gobblet_rl_torch.ops import batched_core as bc
    from gobblet_rl_torch.train import dqn, replay

    config = dqn_config(s)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    ts = dqn.init_train_state(config, QNet(hidden_sizes=config.hidden_sizes, device=dev), gen)
    it, _ = dqn.make_train_iteration(config)
    state = {"env": bc.reset_planes(config.num_envs, dev),
             "buf": replay.make_buffer(config.buffer_size, dev)}

    def step():
        state["env"], state["buf"], loss = it(ts, state["env"], state["buf"], gen)
        return loss

    iters = TIMED_ITERS["dqn"]
    dt, flops = timed_iterations(step, iters, dev)
    result = {
        "metric": "dqn_train_env_steps_per_sec",
        "value": round(iters * dqn_env_steps_per_iter(config) / dt, 1),
        "unit": "steps/s",
        "iterations_per_sec": round(iters / dt, 2),
        "grad_steps_per_sec": round(iters * config.update_per_collect / dt, 1),
        "num_envs": config.num_envs,
        "batch_size": config.batch_size,
    }
    result = roofline(result, flops, iters / dt, dev)
    log(f"# dqn train: {iters} iterations in {dt:.3f}s -> {result['iterations_per_sec']}/s, "
        f"{result['value']:,.0f} env-steps/s, {result['grad_steps_per_sec']} grad-steps/s, "
        f"mfu={result['mfu']}")
    return result


def bench_az_train(s: Settings, dev: torch.device) -> dict:
    """The AlphaZero self-play + update iteration (the zoo recipe's
    configuration)."""
    from gobblet_rl_torch.train import alphazero

    config = az_config(s)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    st = alphazero.init_alphazero(config, gen)
    it = alphazero.make_train_iteration(config)
    iters = TIMED_ITERS["az"]
    dt, flops = timed_iterations(lambda: it(st, gen)["loss"], iters, dev)
    moves = iters * az_moves_per_iter(config)
    result = {
        "metric": "az_train_env_steps_per_sec",
        "value": round(moves / dt, 1),
        "unit": "steps/s",
        "iterations_per_sec": round(iters / dt, 2),
        "sims_per_sec": round(moves * config.num_sims / dt, 1),
        "num_envs": config.num_envs,
        "num_sims": config.num_sims,
        "search": config.search,
    }
    result = roofline(result, flops, iters / dt, dev)
    log(f"# az train: {iters} iterations in {dt:.3f}s -> {result['iterations_per_sec']}/s, "
        f"{result['value']:,.0f} moves/s, {result['sims_per_sec']:,.0f} sims/s, "
        f"mfu={result['mfu']}")
    return result


def bench_ppo_train(s: Settings, dev: torch.device) -> dict:
    """The PPO rollout + GAE + minibatch-epochs iteration (the zoo recipe's
    league configuration), the learner's net its own opponent."""
    from gobblet_rl_torch.train import ppo

    config = ppo_config(s)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    st = ppo.init_ppo(config, gen)
    it = ppo.make_train_iteration(config, "self", device=dev)
    net, opt = st.nets[0], st.optimizers[0]

    def step():
        st.env_states[0], stats = it(net, net, opt, st.env_states[0], gen, "both")
        return stats["loss"]

    iters = TIMED_ITERS["ppo"]
    dt, flops = timed_iterations(step, iters, dev)
    result = {
        "metric": "ppo_train_env_steps_per_sec",
        "value": round(iters * ppo_env_steps_per_iter(config) / dt, 1),
        "unit": "steps/s",
        "iterations_per_sec": round(iters / dt, 2),
        "grad_steps_per_sec": round(iters * config.epochs_per_iter * config.minibatches / dt, 1),
        "num_envs": config.num_envs,
    }
    result = roofline(result, flops, iters / dt, dev)
    log(f"# ppo train: {iters} iterations in {dt:.3f}s -> {result['iterations_per_sec']}/s, "
        f"{result['value']:,.0f} env-steps/s, mfu={result['mfu']}")
    return result


# ---------------------------------------------------------------------------
# the rollout and the host baseline
# ---------------------------------------------------------------------------
def kernel_bytes(batch: int) -> int:
    """Global bytes one call of the rollout kernel moves: the board
    int8[3, 9, B] and the player int32[B] read and written once, and the
    three int64 totals."""
    return batch * (27 + 4) * 2 + 3 * 8


def chain_rates(call, state, s: Settings, dev: torch.device, what: str) -> list[float]:
    """Env-steps/s of ``REPEATS`` calls ``state = call(state, i)`` on one
    state chain after ``WARMUP`` untimed ones; ``call`` returns
    ``(state, stats)``."""
    rates = []
    for i in range(WARMUP + s.repeats):
        sync(dev)
        t0 = time.perf_counter()
        state, stats = call(state, i)
        sync(dev)
        dt = time.perf_counter() - t0
        if i >= WARMUP:
            rates.append(s.batch * s.steps / dt)
            log(f"# {what}: {s.batch * s.steps} env-steps in {dt:.4f}s -> {rates[-1]:,.0f} "
                f"steps/s (episodes={int(stats['episodes'])})")
    med = statistics.median(rates)
    log(f"# {what} median {med:,.0f} steps/s over {s.repeats} repeats (min {min(rates):,.0f}, "
        f"max {max(rates):,.0f}, spread {(max(rates) - min(rates)) / med:.1%})")
    return rates


def bench_rollout(s: Settings, dev: torch.device) -> tuple[float, dict]:
    """(median kernel env-steps/s, the aux line); the kernel's seed varies
    with each call, and its launches go to stderr."""
    from gobblet_rl_torch.kernels import rollout as R
    from gobblet_rl_torch.ops import batched_core as bc

    def kernel(state, i):
        board, current, stats = R.rollout_random_fused(*state, s.steps, seed=i)
        return (board, current), stats

    start = bc.reset_planes(s.batch, dev)
    launches = R.rollout_random_fused.launches
    rates = chain_rates(kernel, (start.board, start.current), s, dev, "rollout kernel")
    log(f"# rollout kernel launches: {R.rollout_random_fused.launches - launches}")
    med = statistics.median(rates)

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    engine = chain_rates(lambda state, i: bc.rollout_random(state, gen, s.steps),
                         bc.reset_planes(s.batch, dev), s, dev, "rollout engine")
    log(f"# rollout engine (eager torch, not the headline): median "
        f"{statistics.median(engine):,.0f} steps/s")

    _, peak_bytes = peaks(dev)
    per_step = kernel_bytes(s.batch) / (s.batch * s.steps)
    aux = {
        "metric": "rollout_roofline",
        "bytes_per_env_step": round(per_step, 4),
        "flops_per_env_step": 0.0,
        "hbm_gbytes_per_sec": None if peak_bytes is None else round(med * per_step / 1e9, 1),
        "hbm_util": None if peak_bytes is None else round(med * per_step / peak_bytes, 4),
        "tflops_per_sec": 0.0,
    }
    return med, aux


def host_baseline(seconds: float = BASELINE_SECONDS) -> float:
    """Env-steps/s of ``BASELINE`` over ``seconds``."""
    from gobblet_rl_torch.board import Board

    rng = np.random.default_rng(0)
    board, player, steps = Board(), 0, 0
    t0 = time.perf_counter()
    while (elapsed := time.perf_counter() - t0) < seconds:
        legal = [a for a in range(54) if board.is_legal(a, player)]
        board.play_turn(player, legal[rng.integers(len(legal))])
        steps += 1
        if board.check_game_over():
            board, player = Board(), 0
        else:
            player = 1 - player
    return steps / elapsed


def describe(dev: torch.device) -> str:
    if dev.type != "cuda":
        return str(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          f"--id={dev.index or 0}"], capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip()
    return f"cuda {smi}"


def main() -> None:
    s = Settings.from_env()
    dev = resolve_device(s.device)
    log(f"# device: {describe(dev)}; torch {torch.__version__}")

    # auxiliary metrics first; the headline last, for parsers of the tail
    if s.want("dqn"):
        print(json.dumps(bench_dqn_train(s, dev)), flush=True)
    if s.want("az"):
        print(json.dumps(bench_az_train(s, dev)), flush=True)
    if s.want("ppo"):
        print(json.dumps(bench_ppo_train(s, dev)), flush=True)
    if s.want("rollout"):
        median_rate, aux = bench_rollout(s, dev)
        baseline = host_baseline()
        log(f"# baseline: {baseline:,.1f} steps/s over {BASELINE_SECONDS} s, {BASELINE}")
        print(json.dumps(aux))
        print(json.dumps({
            "metric": "env_steps_per_sec",
            "value": round(median_rate, 1),
            "unit": "steps/s",
            "vs_baseline": round(median_rate / baseline, 1),
        }))


if __name__ == "__main__":
    main()
