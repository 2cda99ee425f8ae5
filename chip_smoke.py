"""Smoke run of the PyTorch/CUDA port (``gobblet_rl_torch``) on one card.

    python3 chip_smoke.py

Drives the port's main path at full width and holds every kernel against
its plain PyTorch version:

1. the card's name and power limit;
2. builds the CUDA kernel from ``gobblet_rl_torch/kernels/csrc`` with nvcc;
3. the fused-rollout kernel vs its plain version on the card (field mode
   and Philox mode at B=16384, Philox mode at a ragged B=4099; 32 plies):
   board, player and stats must be bit-identical (tolerance 0);
4. the full-width rollout through the kernel (B=524288, 64 plies, 2 warm-ups
   + 5 timed calls on one state chain) beside the engine's
   ``batched_core.rollout_random``, with the episode invariants checked;
5. the full-width DQN iteration (262,144 envs, the bench configuration with
   the dueling head), then ``dqn.train`` for one epoch of two iterations;
6. the kernel line: launches on the main path (phases 4-5), agreement with
   the plain version at the main path's shape, times and the bound.

Any failed check raises, so the exit code is non-zero.  The last line is
``{"ok": true, "device": {...}}``.  Needs one CUDA card; imports no JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

ROLLOUT_B, ROLLOUT_STEPS, REPEATS = 524288, 64, 5
CHECK_B, CHECK_STEPS, RAGGED_B = 16384, 32, 4099
DQN = dict(num_envs=262144, buffer_size=4194304, batch_size=4096, segment_len=16,
           update_per_collect=8, n_step=3, opponent="random",
           hidden_sizes=(128, 128, 128, 128), double=True, dueling=True)

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, and 67e12/s, the
# float32 rate outside the tensor cores.  The data sheet gives no 32-bit
# integer rate, so the float32 rate is used here for int32 operations.
PEAK_HBM_BYTES = 3.35e12
PEAK_32BIT_OPS = 67e12
# 32-bit integer operations of the rollout kernel in Philox mode, counted
# from csrc/rollout.cu: one per arithmetic, logic, compare or select of the
# source, each counted once in the scope its operands vary in (ply, block or
# env), with constants folded and unused Philox words dropped.
OPS_PER_PLY = {
    "philox: 14 blocks x 60, 10 shared by the blocks, 4 unused": 14 * 60 + 10 - 4,
    "player sign": 2,
    "cell pass (top piece, size, frozen bits): 9 cells x 27": 9 * 27,
    "legality 129, then draw and running max: 54 actions x 5": 129 + 54 * 5,
    "placement: target 11, then 27 cells x 4": 11 + 27 * 4,
    "top pieces after the move: 9 cells x 4": 9 * 4,
    "win fold: 18 sign tests, then 8 lines x 7": 18 + 8 * 7,
    "counts 8 and reset 27": 8 + 27,
    "ply loop": 2,
}
# once per env: key schedule 18, per-block constants 70, warp reduction 30
OPS_PER_ENV = 18 + 70 + 30


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"check failed: {what}")


def valid_boards(board: torch.Tensor) -> bool:
    """Every piece id at most once, each on its own level (all envs)."""
    for level in range(3):
        own = {2 * level + 1, 2 * level + 2}
        for v in range(1, 7):
            for s in (1, -1):
                count = (board[level] == s * v).sum(dim=0)
                if int(count.max()) > (1 if v in own else 0):
                    return False
    return True


def timed(fn, repeats: int):
    """Run ``fn`` ``repeats`` times; (result, [ms per call] by CUDA events)."""
    out, ms = None, []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    return out, ms


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one card",
              file=sys.stderr)
        return 2

    from gobblet_rl_torch.kernels import build
    from gobblet_rl_torch.kernels import rollout as R
    from gobblet_rl_torch.ops import batched_core as bc
    from gobblet_rl_torch.train import dqn, replay

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device -------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(smi)
    log(f"# device {kind}; python {sys.version.split()[0]}; torch {torch.__version__}; "
        f"cuda {torch.version.cuda}")

    # 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    lib, nvcc_log = build.build("rollout")
    log(f"# build: rollout in {time.perf_counter() - t0:.2f}s -> {lib.name}")
    for line in nvcc_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"#   {line.strip()}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    # 3. kernel vs plain version, small batch -------------------------------
    start, _ = bc.rollout_random(bc.reset_planes(CHECK_B, dev), gen, 5)  # mid-game states
    board, cur = start.board.contiguous(), start.current.contiguous()
    field = torch.randint(-2**31, 2**31, (CHECK_STEPS, 54, CHECK_B), dtype=torch.int32,
                          device=dev, generator=gen).view(torch.uint32)
    # the ragged batch leaves the last block of 256 threads partly empty
    for mode, n, draws, seed in (("field", CHECK_B, field, 0), ("philox", CHECK_B, None, 7),
                                 ("philox", RAGGED_B, None, 3)):
        b, c = board[..., :n].contiguous(), cur[:n].contiguous()
        kb, kc, ks = R.rollout_random_fused(b, c, CHECK_STEPS, seed=seed, draws=draws)
        ref = field if draws is not None else R.philox_field(seed, CHECK_STEPS, n, dev)
        pb, pc, ps = R.rollout_random_fused_plain(b, c, CHECK_STEPS, ref)
        torch.cuda.synchronize()
        check(torch.equal(kb, pb) and torch.equal(kc, pc), f"{mode}: kernel state == plain")
        for k in ks:
            check(int(ks[k]) == int(ps[k]), f"{mode}: kernel {k} == plain")
        log(f"# check {mode} B={n} plies={CHECK_STEPS}: bit-identical (tolerance 0), "
            f"episodes={int(ks['episodes'])}")
    del field

    # 4 + 5. the main path; the launch counts cover exactly these phases ----
    R.rollout_random_fused.launches = 0
    state = bc.reset_planes(ROLLOUT_B, dev)
    kb, kc = state.board, state.current
    seed = 0
    kernel_ms, kernel_rates = [], []
    for i in range(2 + REPEATS):
        t0 = time.perf_counter()
        (kb, kc, stats), ms = timed(lambda: R.rollout_random_fused(kb, kc, ROLLOUT_STEPS, seed=seed), 1)
        dt = time.perf_counter() - t0
        eps, w1, w2 = (int(stats[k]) for k in ("episodes", "wins_p1", "wins_p2"))
        check(eps == w1 + w2, "episodes == wins_p1 + wins_p2")
        check(eps > ROLLOUT_B, "more episodes than envs")
        check(0.4 < w1 / eps < 0.7, f"P1 share {w1 / eps:.3f} in (0.4, 0.7)")
        seed += 1
        if i >= 2:
            kernel_ms.append(ms[0])
            kernel_rates.append(ROLLOUT_B * ROLLOUT_STEPS / dt)
    check(valid_boards(kb), "final boards valid")
    kernel_start = (kb, kc, seed)  # a mid-chain state for the full-width comparison
    log(json.dumps({"metric": "kernel_rollout_env_steps_per_sec", "device": smi,
                    "batch": ROLLOUT_B, "plies": ROLLOUT_STEPS,
                    "median": statistics.median(kernel_rates), "all": kernel_rates,
                    "ms_median": statistics.median(kernel_ms), "ms_all": kernel_ms,
                    "p1_share": w1 / eps}))

    state = bc.reset_planes(ROLLOUT_B, dev)
    engine_ms, engine_rates = [], []
    for i in range(2 + REPEATS):
        t0 = time.perf_counter()
        (state, stats), ms = timed(lambda: bc.rollout_random(state, gen, ROLLOUT_STEPS), 1)
        dt = time.perf_counter() - t0
        check(int(stats["episodes"]) == int(stats["wins_p1"]) + int(stats["wins_p2"]),
              "engine episodes == wins")
        if i >= 2:
            engine_ms.append(ms[0])
            engine_rates.append(ROLLOUT_B * ROLLOUT_STEPS / dt)
    check(valid_boards(state.board), "engine boards valid")
    log(json.dumps({"metric": "engine_rollout_env_steps_per_sec", "device": smi,
                    "batch": ROLLOUT_B, "plies": ROLLOUT_STEPS,
                    "median": statistics.median(engine_rates), "all": engine_rates,
                    "ms_median": statistics.median(engine_ms)}))
    del state

    config = dqn.DQNConfig(**DQN)
    torch.cuda.reset_peak_memory_stats()
    ts = dqn.init_train_state(config, dqn.make_net(config), gen)
    it, opp_fn = dqn.make_train_iteration(config)
    env_state = dqn.init_env_state(config, opp_fn, ts.opponent_net, gen)
    buffer = replay.make_buffer(config.buffer_size)
    for _ in range(2):
        env_state, buffer, loss = it(ts, env_state, buffer, gen)
    torch.cuda.synchronize()
    iters, t0 = 3, time.perf_counter()
    for _ in range(iters):
        env_state, buffer, loss = it(ts, env_state, buffer, gen)
    loss = float(loss)  # synchronises
    dt = time.perf_counter() - t0
    L = config.segment_len + config.n_step - 1
    check(torch.isfinite(torch.tensor(loss)).item(), "dqn loss finite")
    check(ts.grad_steps == 5 * config.update_per_collect, "dqn grad_steps")
    check(buffer.filled == config.buffer_size and buffer.cursor == 0, "ring full, cursor 0")
    check(bool((env_state.current == 0).all()), "every env at the learner's turn")
    log(json.dumps({"metric": "dqn_train_env_steps_per_sec", "device": smi,
                    "value": iters * config.num_envs * L / dt,
                    "iteration_ms": 1e3 * dt / iters, "loss": loss,
                    "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}))
    del ts, env_state, buffer

    t0 = time.perf_counter()
    ts, history = dqn.train(
        dqn.DQNConfig(**DQN, epoch=1, step_per_epoch=2), device=dev
    )
    rec = history[-1]
    check(len(history) == 1 and torch.isfinite(torch.tensor(rec["loss"])).item(), "train loss")
    check(rec["wins"] + rec["losses_games"] + rec["other"] > 0, "train eval record")
    check(ts.grad_steps == 2 * config.update_per_collect, "train grad_steps advanced")
    log(json.dumps({"metric": "dqn_train_run", "seconds": time.perf_counter() - t0, **rec}))
    del ts
    launches = R.rollout_random_fused.launches
    check(launches > 0, "the main path launched the rollout kernel")

    # 6. kernel vs plain at the main path's shape, outside the counted run --
    kb, kc, seed = kernel_start
    field = R.philox_field(seed, ROLLOUT_STEPS, ROLLOUT_B, dev)
    (pb, pc, ps), plain_ms = timed(
        lambda: R.rollout_random_fused_plain(kb, kc, ROLLOUT_STEPS, field), 2)
    (ob, oc, os_), _ = timed(lambda: R.rollout_random_fused(kb, kc, ROLLOUT_STEPS, seed=seed), 1)
    err = max(int((ob.int() - pb.int()).abs().max()), int((oc - pc).abs().max()),
              *(abs(int(os_[k]) - int(ps[k])) for k in ps))
    check(err == 0, "kernel == plain at full width")
    del field

    nbytes = ROLLOUT_B * (27 + 4) * 2 + 3 * 8
    ops = ROLLOUT_B * (ROLLOUT_STEPS * sum(OPS_PER_PLY.values()) + OPS_PER_ENV)
    bytes_ms, ops_ms = 1e3 * nbytes / PEAK_HBM_BYTES, 1e3 * ops / PEAK_32BIT_OPS
    log(smi)
    log(json.dumps({"kernels": [{
        "name": "rollout_random_fused",
        "route": "cuda",
        "source": "gobblet_rl_torch/kernels/csrc/rollout.cu",
        "replaces": "gobblet_rl_tpu/ops/pallas_rollout.py:176",
        "launches": launches,
        "max_abs_err": err,
        "ms": statistics.median(kernel_ms),
        "plain_ms": min(plain_ms),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
        "library_ms": None,
    }]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
