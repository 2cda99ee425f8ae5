"""Smoke run of the PyTorch/CUDA port (``gobblet_rl_torch``) on one card.

    python3 chip_smoke.py

Drives the port's main path at full width and holds every kernel against
its plain PyTorch version:

1. the card's name and power limit;
2. builds the CUDA kernel from ``gobblet_rl_torch/kernels/csrc`` with nvcc,
   checks that ptxas reports no spills, prints the blocks per SM and counts
   the machine instructions of the ply loop (cuobjdump);
3. the fused-rollout kernel vs its plain version on the card (field mode
   and Philox mode at B=16384, Philox mode at a ragged B=4099; 32 plies;
   from states 5 plies and 40 plies deep): board, player and stats must be
   bit-identical (tolerance 0);
4. the full-width rollout through the kernel (B=524288, 64 plies, 2 warm-ups
   + 5 timed calls on one state chain) beside the engine's
   ``batched_core.rollout_random``, with the episode invariants checked;
5. the full-width DQN iteration (262,144 envs, the bench configuration with
   the dueling head), then ``dqn.train`` for one epoch of two iterations;
6. the kernel line: launches on the main path (phases 4-5, and phase 24's
   bench and bench_scaling in processes of their own), agreement with
   the plain version at the main path's shape, times and the bound (the
   larger of bytes over HBM bandwidth and the ply loop's instructions over
   the SMs' integer rates; see the constants below), printed after 7-14;
7. the batched depth-2 greedy on 262,144 positions 5 plies deep (1 warm-up,
   3 calls timed by CUDA events, peak memory); every action legal, and on
   4,096 positions one injected Gumbel field gives the same actions on the
   card and on the CPU;
8. the DQN iteration against the greedy opponent with ``learner_player=
   "both"`` (phase 5's configuration otherwise): 1 warm-up and 2 timed
   iterations, each split by CUDA events into collect, fold + insert,
   sample and updates;
9. the command line ``example_dqn.main`` with ``--opponent mixed
   --both-seats --training-num 16384``, one epoch of two iterations with
   ``--full-resume-dir``, then relaunched with ``--epoch 2``: exactly one
   more epoch, twice the gradient steps, and the restored payload equal,
   tensor for tensor, to the saved one;
10. the vector env: ``vector_reset`` + ``rollout`` with ``random_policy``
    over 64 plies at B=524,288;
11. the zoo agent ``dqn_greedy`` on the card: Q-values on 4,096 positions
    against the CPU's, then 2,048 games against the depth-2 greedy with
    colours swapped (win rate at least 0.80);
12. the Gumbel search (32 simulations) on 1,024 positions 5 plies deep with
    a float32 conv net and one injected noise field, on the card and on the
    CPU: at least 0.99 of the roots with identical actions and visits, every
    action legal; then two calls at 2,048 roots timed, its peak memory, and
    one call under torch.profiler (device kernel time, idle share);
13. the AlphaZero iteration of ``bench.py`` at full width (2,048 envs, 32
    simulations, segment 48, conv 64x2, 8 updates of 2,048): 1 warm-up and
    2 timed iterations split by CUDA events into self-play segment,
    outcomes + flatten and updates; loss finite, policy targets on the legal
    actions summing to 1, decisive winners, params changed, no rollout
    kernel launched; then ``alphazero.train`` at 256 envs and segment 16
    for 2 iterations with ``full_resume_dir``, relaunched for a third, once
    with the Gumbel search and once with PUCT (``AZConfig``'s default: root
    Dirichlet noise, visit sampling for the first 8 plies): the restored
    payload equals the saved one, tensor for tensor, and every segment's
    targets pass the checks above;
14. the zoo agent ``alphazero_gumbel32`` on the card: logits and values on
    4,096 positions against the CPU's, then 128 games against the depth-2
    greedy with colours swapped at the manifest's 128 simulations and
    ``play_match``'s default cap of 100 plies, the manifest's protocol (win
    rate at least 0.85; the games past 50 plies counted);
15. the PPO iteration of ``bench.py`` at full width (8,192 envs, segment
    32, one shared MLP 128x128, both seats, the "self" opponent, 4 epochs
    of 8 minibatches): 1 warm-up and 3 timed iterations split by CUDA
    events into rollout, GAE + flatten and updates; loss finite, episodes,
    params changed, every recorded action legal, every env at its learner
    seat's turn, no rollout kernel launched; one more iteration under
    torch.profiler (device kernel time, idle share);
16. the ``ppo_league`` recipe at its width (512 envs, the 4-leg league,
    the "search" attacker at 4 simulations, the defense term over a
    384-game bank of both sides): the bank built on the host (seconds,
    rows), one iteration of each leg (random, greedy, pool, search), then
    ``example_ppo.main`` with the recipe's flags for 2 iterations with
    ``--checkpoint-dir``, relaunched for a third (exactly one more
    iteration; the restored payload equal to the saved one), and one
    phase-5 DQN iteration with the defense term (loss finite);
17. the zoo agent ``ppo_league`` on the card: logits and values on 4,096
    positions against the CPU's, 2,048 games against the depth-2 greedy with
    colours swapped (win rate at least 0.80), and ``defense_audit`` (32
    games, the exact solver at depth 18 attacking; every move graded),
    printed with the solver's host seconds apart from the rest; then the
    same audit against oracles of fixed salts 0-3, each from a cleared
    solver table (salt and table pick the attack line among equally fast
    wins): plies survived and mistakes per game exactly those of the CPU
    and of the JAX package for the same salts;
18. the learned-eval value search: exact float32 nets (a plain-headed
    ``QNet`` and an ``MLPActorCritic``, one hidden layer, weights multiples
    of 2^-6) on 256 positions 10 plies deep under one tie field, at depth 1
    and at depth 2 with the leaf solver on and off, card against CPU: the
    DQN head's actions identical, the actor-critic's leaf values within
    1e-6 and its actions identical wherever the two best noisy scores are
    more than 1e-6 apart; then ``alphazero_gumbel32+search2`` and
    ``dqn_greedy+search2`` timed (1 warm-up, 3 calls by CUDA events) at 64
    and 1,024 positions, every action legal, peak memory at most 16 GiB;
19. the tournament command line ``example_tournament.main`` (random,
    greedy-2 and both ``+search2`` entrants, 64 games a pair): every pair's
    games accounted for, both entrants rated above greedy-2 and greedy-2
    above random; then ``alphazero_gumbel32+search2`` against the exact
    solver at depth 15, 8 games moving first (no loss, win rate at least
    0.85);
20. the per-env functional API at 262,144 envs for 64 plies from
    ``batched_reset``: ``batched_step_strict`` and ``step_planes`` on one
    stream (random legal moves, an arbitrary one every 8th ply, no
    auto-reset) equal field for field at every ply, ``batched_legal_mask``
    equal to ``legal_mask_planes``, the debug invariants holding on every
    env and ``checked_step`` raising on a corrupted board;
21. the host agents on the card: the single-env ``NativeEngine`` against
    the NumPy rules on every board of the depth-2 tree (legal masks for both
    players, winners) and its greedy-2 against random in 200 games (more
    than 0.90 of the decided games); ``zoo.host_agent`` of ``dqn_greedy``
    and ``ppo_league`` on the card in whole games from both seats against
    ``AlphaBetaGobbletPolicy(depth=6)`` (the port's board and reference
    observations, no pettingzoo), every action legal, the median ms a move
    of each agent and of alpha-beta, and the card's moves equal to the CPU
    host agent's wherever the CPU net's two best legal values are more
    than twice 2e-2 of its largest magnitude apart; the AlphaZero host agent
    (``alphazero_gumbel32`` at the manifest's 128 simulations) and
    ``SearchAgentPolicy`` at 128 simulations, 1 warm-up and 2 timed moves
    each; one ``SearchAgentPolicy`` move profiled through
    ``utils.profiling.trace`` inside ``annotate("host_search_move")`` (the
    trace file names the annotation; kernels, device ms, idle share);
22. the parallel slice (``gobblet_rl_torch/parallel``; no speed-up is
    claimed: one card).  World size 1 over NCCL: the sharded DQN iteration
    at phase 5's width and AZ at 256 envs and segment 16 equal to the
    unsharded ones from one seed (params, ring, env state, loss:
    ``torch.equal``), each timed, and the gradient sync's ms an update by
    CUDA events; the sharded PPO at phase 15's width timed (loss finite,
    params moved); PPO card against CPU (a gloo rank) at 64 envs on exact
    linear nets under one set of draws, params within 1e-5.  Two gloo
    ranks on the one card (NCCL refuses two ranks on one device):
    ``launch_local`` of the DQN at phase 5's width split over them, AZ and
    PPO at 16 envs (one digest each), and a TP forward and SGD step of the
    dueling ``QNet`` at batch 4,096 within 1e-5 of the replicated net, and
    the census of one DP iteration (only all-reduces, at most updates x
    (param bytes + 4096)); the launches run at once, beside the AZ check;
23. the repository's tools on the card: ``make_zoo --quick --entries
    ppo_league --eval-games 8`` as a command line into a temporary zoo (the
    manifest row, the blob, its policy's moves legal), in a process of its
    own beside the rest: every committed zoo entry loaded, written back by
    ``zoo.save`` into a temporary directory (the same bytes as the
    committed blob) and reloaded (every weight equal); ``profile_dqn
    --family dqn --envs 262144 --iters 3`` (busy share in (0, 1], the
    classes summing to the device total, every row called); and
    ``exploitability --agents dqn_greedy random --games 8 --defense-games
    4`` (a forced loss for each agent as second player);
24. the repository's timing tools on the card, as command lines in
    processes of their own, started before phase 23 and run beside it:
    ``python -m gobblet_rl_torch.scripts.bench`` at its defaults but the
    AlphaZero segment (8 plies, not 48; phase 13 times the full iteration)
    and ``python -m gobblet_rl_torch.scripts.bench_scaling`` (size 1 on one
    card): the headline last and positive, the three train lines with
    ``0 <= mfu <= 1``, the rollout kernel launched by the bench's headline
    section, the scaling summary at one device; their lines and seconds.

Phases 7-24 each print one JSON line with the card's name and power limit
and the phase's seconds.

Any failed check raises, so the exit code is non-zero.  The last line is
``{"ok": true, "device": {...}}``.  Needs one CUDA card; imports no JAX.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import ctypes
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROLLOUT_B, ROLLOUT_STEPS, REPEATS = 524288, 64, 5
CHECK_B, CHECK_STEPS, RAGGED_B = 16384, 32, 4099
DQN = dict(num_envs=262144, buffer_size=4194304, batch_size=4096, segment_len=16,
           update_per_collect=8, n_step=3, opponent="random",
           hidden_sizes=(128, 128, 128, 128), double=True, dueling=True)
GREEDY_B, GREEDY_PARITY_B, ZOO_GAMES, ZOO_MIN_WIN_RATE = 262144, 4096, 2048, 0.80
CLI_ARGS = ["--opponent", "mixed", "--both-seats", "--training-num", "16384",
            "--step-per-epoch", "2"]
# The AlphaZero iteration of bench.py (bench.py:65-70, 233-237), not cut.
AZ = dict(search="gumbel_lm", num_sims=32, num_envs=2048, segment_len=48, model="conv",
          channels=64, blocks=2, batch_size=2048, updates_per_iter=8)
SEARCH_PARITY_B, SEARCH_MIN_SAME = 1024, 0.99
# the resume checks and the zoo match are cut to keep the script well
# inside its time on a slow host: segment 16, and 128 games (the match went
# from 256 games to 128 when the parallel phase took all phases to 626.2 s
# on a slow host).  The match plays play_match's default cap of 100 plies,
# the protocol of the manifest's figure (scripts/make_zoo.py:35-49); the
# launch-bound match runs until its last game ends, and a game still open
# at the cap counts as undecided, outside the win rate.  The games still
# open after 50 plies are counted.
AZ_RESUME_ENVS, AZ_RESUME_SEGMENT, AZ_ZOO_GAMES, AZ_ZOO_LONG_PLIES = 256, 16, 128, 50
AZ_ZOO_MIN_WIN_RATE = 0.85
# The PPO iteration of bench.py (bench.py:276-322), not cut.
PPO = dict(num_envs=8192, segment_len=32, shared_policy=True, learner_player="both",
           opponent="self", hidden_sizes=(128, 128), epochs_per_iter=4, minibatches=8)
# The recipe of the zoo's ppo_league (gobblet_rl_tpu/zoo/manifest.json), at
# its width; the bank's depth is PPOConfig's default, 16.
LEAGUE = dict(shared_policy=True, learner_player="both", opponent="mixed",
              mixed_weights=(0.1, 0.6, 0.2, 0.1), search_sims=4, defense_bc_weight=1.0,
              defense_bank_games=384, defense_bank_sides="both", num_envs=512, seed=1626)
LEAGUE_ARGS = ["--shared-policy", "--learner-player", "both", "--opponent", "mixed",
               "--mixed-weights", "0.1", "0.6", "0.2", "0.1", "--search-sims", "4",
               "--defense-bc-weight", "1.0", "--defense-bank-games", "384",
               "--defense-bank-sides", "both", "--num-envs", "512", "--seed", "1626"]
PPO_ZOO_MIN_WIN_RATE, AUDIT_GAMES, AUDIT_DEPTH = 0.80, 32, 18
# (mean plies survived, mistakes per game) of ppo_league against the oracle
# of each fixed salt from a cleared table: what tools/ppo_league_cpu.py
# prints on the CPU, and what the JAX package's audit gives for each salt
AUDIT_BY_SALT = {0: (12.0, 0.5), 1: (7.6875, 0.96875), 2: (12.875, 0.0625),
                 3: (10.9375, 1.03125)}
# The value search: card against CPU, then the zoo entrants' time at the
# tournament command line's default width (64 games a half) and at 1,024.
VS_PARITY_B, VS_PARITY_PLIES, VS_TIMING_B, VS_MAX_PEAK_GIB = 256, 10, (64, 1024), 16.0
TOURNAMENT_ARGS = ["--agents", "random", "greedy-2", "--zoo-search", "dqn_greedy",
                   "alphazero_gumbel32", "--games", "64", "--seed", "0", "--json"]
# the TPU round's grand table (docs/RESULTS.md:416-427): context only
TPU_ROUND_ELO = {"alphazero_gumbel32+search2": 1170, "dqn_greedy+search2": 1116,
                 "greedy-2": 778, "random": 210}
SOLVER_GAMES, SOLVER_MAX_PLIES, SOLVER_MIN_WIN_RATE = 8, 60, 0.85
# make_zoo's quick pipeline runs as a command line of its own (phase 23)
TOOLS_MAKE_ZOO_TIMEOUT = 300
# The timing tools (phase 24) at the bench's defaults but the AlphaZero
# segment: 8 plies, not 48, so the bench lasts about as long as phase 23
# beside which it runs (phase 13 times the full-width iteration, and the
# search is launch-bound: a ply costs about the same at any env count).
BENCH_ENV = {"GOBBLET_BENCH_AZ_SEGMENT": "8"}
BENCH_TIMEOUT, BENCH_KERNEL_LAUNCHES, SCALING_KERNEL_LAUNCHES = 600, 2 + 5, 1 + 3
API_B, API_PLIES, API_ARBITRARY_EVERY = 262144, 64, 8
# The host agents: games a seat against alpha-beta, their ply cap (two
# deterministic players can repeat forever: the game has no repetition
# rule), the compare rule's tolerance, the search agents' timed moves.
HOST_GAMES_PER_SEAT, HOST_MAX_PLIES, HOST_AB_DEPTH, HOST_TOL = 2, 60, 6, 2e-2
# Two timed moves a search agent, not three: on a slow host all phases
# took 563.5 s with three, near the 600 s at which earlier phases are cut.
HOST_AZ_SIMS, HOST_AZ_MOVES = 128, 2
# The parallel slice.  World size 1 over NCCL: phase 5's DQN, the AZ resume
# checks' cut and phase 15's PPO, each against the unsharded iteration;
# card against CPU for PPO at a small width on exact linear nets (a hidden
# ReLU at its kink flips a row's gradient under float32 reordering, which
# Adam inflates to ~lr).  Then two gloo ranks on the one card: the DQN at
# phase 5's width split over them, AZ and PPO at launch_local's widths, a
# TP forward and step of QNet and the census of one DP iteration.
PAR_BACKEND, PAR_RANK_BACKEND = "nccl", "gloo"
PAR_AZ = dict(AZ, num_envs=AZ_RESUME_ENVS, segment_len=AZ_RESUME_SEGMENT)
PAR_PPO_SMALL = dict(num_envs=64, segment_len=8, shared_policy=True, learner_player="both",
                     opponent="self", hidden_sizes=(), epochs_per_iter=2, minibatches=4, lr=1e-3)
PAR_TOL, PAR_SYNC_REPEATS, PAR_TP_B = 1e-5, 20, 4096
PAR_SMALL = {"az": 16, "ppo": 16}   # launch_local's JAX widths (tests/test_multihost.py:44)
PAR_CENSUS = dict(num_envs=4096, buffer_size=65536, batch_size=1024, segment_len=4,
                  update_per_collect=2, opponent="random")

# The bound.  Bytes: HBM at 3.35e12 B/s (NVIDIA's H100 SXM data sheet).
# Operations: the machine instructions of the kernel's ply loop, read from
# the built library with cuobjdump, times the env-plies, over two rates of
# an SM at the clock nvidia-smi reports as clocks.max.sm.  The CUDA C++
# Programming Guide's table of arithmetic instruction throughput gives
# compute capability 9.0 64 results a clock per SM for 32-bit integer add,
# compare, min/max, logic and shift: the integer ALU pipe that INT_ALU_OPS
# run on.  Multiply-adds (IMAD, also used for moves and shifts) run on the
# FMA pipe beside it, so every instruction is bounded only by issue: four
# schedulers an SM, each one warp instruction (32 threads) a clock.  The
# larger of the two is the issue floor of the code that runs, not of the
# function.
PEAK_HBM_BYTES = 3.35e12
SMS, INT_ALU_PER_CLOCK, ISSUE_PER_CLOCK = 132, 64, 128
INT_ALU_OPS = {"LOP3", "PLOP3", "ISETP", "SEL", "SHF", "IMNMX", "VIMNMX", "IADD3", "IABS"}
# Without cuobjdump: 32-bit integer operations per env-ply counted from
# csrc/rollout.cu in Philox mode, one per arithmetic, logic, compare or
# select of the source, each once in the scope its operands vary in, at the
# issue rate.  The compiler fuses some of them (three-input LOP3 and IADD3),
# so this count lies above the compiled one, and its floor above the SASS
# floor.
OPS_PER_PLY = {
    "philox: 11 blocks x 60, 10 shared by the blocks": 11 * 60 + 10,
    "draws to bits 8-31: 7 per block, 1 unused": 11 * 7 - 1,
    "keys: or the code, 54 actions": 54,
    "legality: shift and test, 54 actions x 2": 54 * 2,
    "max of the legal keys: 54": 54,
    "occupancy 3, covering levels 3, free cells 2, legal words 2 x 7": 3 + 3 + 2 + 2 * 7,
    "placement: decode 4, masks 6, update 4": 4 + 6 + 4,
    "winner: occupancy 6, top cells 2 x 6, table 2, done and counts 8": 6 + 2 * 6 + 2 + 8,
    "swap and reset 4, player 2, ply loop 2": 4 + 2 + 2,
}


def smi_query(fields: str) -> str:
    """One line of ``nvidia-smi --query-gpu=<fields>`` for the first card."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def sass_functions(lib: Path) -> dict[str, list[tuple[int, str, str]]]:
    """``{mangled name: [(address, opcode, operands), ...]}`` of every kernel
    in ``lib``, from ``cuobjdump -sass`` beside ``nvcc`` (which gives branch
    targets as addresses).  Raises FileNotFoundError if there is none."""
    from gobblet_rl_torch.kernels import build

    tool = Path(build.nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                         check=True).stdout
    funcs: dict[str, list[tuple[int, str, str]]] = {}
    body = None
    for line in out.splitlines():
        if "Function :" in line:
            body = funcs.setdefault(line.split("Function :", 1)[1].strip(), [])
        elif body is not None and (m := _INSN.search(line)):
            body.append((int(m.group(1), 16), m.group(2), m.group(3)))
    return funcs


def sass_loop(lib: Path, function: str) -> dict:
    """The largest loop of the kernel whose mangled name contains
    ``function``: the span from a backward branch's target to the branch.
    Returns ``{"kernel", "instructions", "opcodes"}``, counting every
    instruction of the span but ``NOP``: the issue slots one pass takes.
    Raises if the span holds another branch, which would make the count
    depend on the path taken."""
    matches = {k: v for k, v in sass_functions(lib).items() if function in k}
    if len(matches) != 1:
        raise RuntimeError(f"{len(matches)} kernels in {lib.name} match {function!r}")
    (kernel, body), = matches.items()
    best: list[tuple[int, str, str]] = []
    for addr, op, args in body:
        m = re.search(r"0x([0-9a-f]+)", args)
        if op.startswith("BRA") and m and int(m.group(1), 16) < addr:
            span = [x for x in body if int(m.group(1), 16) <= x[0] <= addr and x[1] != "NOP"]
            if len(span) > len(best):
                best = span
    if not best:
        raise RuntimeError(f"no loop in {kernel}")
    ops = collections.Counter(op.split(".")[0] for _, op, _ in best)
    if ops["BRA"] != 1:
        raise RuntimeError(f"the loop of {kernel} holds {ops['BRA']} branches, not 1")
    return {"kernel": kernel, "instructions": len(best), "opcodes": dict(ops.most_common())}


def sass_counts(lib: Path) -> tuple[int, int, dict] | None:
    """(instructions, of them on the integer ALU pipe, opcode counts) of the
    Philox-mode ply loop in the built library ``lib``, or None if the
    toolkit has no cuobjdump."""
    try:
        loop = sass_loop(lib, "rollout_kernelILb0E")
    except FileNotFoundError:
        return None
    alu = sum(n for op, n in loop["opcodes"].items() if op in INT_ALU_OPS)
    return loop["instructions"], alu, loop["opcodes"]


def issue_floor_ms(per_ply: int, alu_per_ply: int, env_plies: int, sm_mhz: float) -> float:
    """The larger of the ALU-pipe floor and the issue floor, in ms."""
    clocks = env_plies * max(alu_per_ply / INT_ALU_PER_CLOCK, per_ply / ISSUE_PER_CLOCK)
    return 1e3 * clocks / (sm_mhz * 1e6 * SMS)


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


def cuda_mark(marks: list):
    """A ``mark`` hook for ``train_iteration``: records a CUDA event per
    phase name."""
    def mark(name):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        marks.append((name, event))
    return mark


def phase_greedy(smi: str, gen: torch.Generator) -> None:
    """7. the batched greedy at depth 2."""
    from gobblet_rl_torch.ops import batched_core as bc
    from gobblet_rl_torch.policies import greedy_jax

    t0 = time.perf_counter()
    dev = gen.device
    state, _ = bc.rollout_random(bc.reset_planes(GREEDY_B, dev), gen, 5)
    board, cur = state.board, state.current
    del state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timed(lambda: greedy_jax.greedy_actions(gen, board, cur, 2), 1)
    actions, ms = timed(lambda: greedy_jax.greedy_actions(gen, board, cur, 2), 3)
    peak = torch.cuda.max_memory_allocated()
    mask = bc.legal_mask_planes(board, cur)
    check(bool(mask[actions.long(), torch.arange(GREEDY_B, device=dev)].all()),
          "greedy: every action legal")
    n = GREEDY_PARITY_B
    field = bc.gumbel_field(gen, (54, n), dev)
    on_card = greedy_jax.greedy_actions(None, board[..., :n], cur[:n], 2, gumbel=field)
    on_cpu = greedy_jax.greedy_actions(None, board[..., :n].cpu(), cur[:n].cpu(), 2,
                                       gumbel=field.cpu())
    mismatches = int((on_card.cpu() != on_cpu).sum())
    check(mismatches == 0, "greedy: card == CPU under one injected field")
    log(json.dumps({"metric": "greedy_depth2_ms", "device": smi, "batch": GREEDY_B,
                    "plies_deep": 5, "ms_median": statistics.median(ms), "ms_all": ms,
                    "peak_mem_gib": peak / 2**30, "player1_share": float(cur.float().mean()),
                    "cpu_parity_positions": n, "cpu_mismatches": mismatches,
                    "seconds": time.perf_counter() - t0}))


def phase_greedy_dqn(smi: str, gen: torch.Generator) -> None:
    """8. the DQN iteration against the greedy opponent, split by phase."""
    from gobblet_rl_torch.train import dqn, replay

    t0 = time.perf_counter()
    config = dqn.DQNConfig(**{**DQN, "opponent": "greedy", "learner_player": "both"})
    torch.cuda.reset_peak_memory_stats()
    ts = dqn.init_train_state(config, dqn.make_net(config, gen.device), gen)
    it, opp_fn = dqn.make_train_iteration(config)
    env_state = dqn.init_env_state(config, opp_fn, ts.opponent_net, gen)
    buffer = replay.make_buffer(config.buffer_size, gen.device)
    env_state, buffer, loss = it(ts, env_state, buffer, gen)
    torch.cuda.synchronize()
    runs = []
    for _ in range(2):
        marks = []
        mark = cuda_mark(marks)
        w0 = time.perf_counter()
        mark("start")
        env_state, buffer, loss = it(ts, env_state, buffer, gen, mark=mark)
        loss = float(loss)  # synchronises
        wall_ms = 1e3 * (time.perf_counter() - w0)
        check(math.isfinite(loss), "greedy dqn: loss finite")
        phases = {name: prev.elapsed_time(event)
                  for (_, prev), (name, event) in zip(marks, marks[1:])}
        runs.append({"iteration_ms": wall_ms, **{f"{k}_ms": v for k, v in phases.items()},
                     "loss": loss})
    seats = dqn.seat_array("both", config.num_envs, env_state.current.device)
    check(bool((env_state.current == seats).all()), "greedy dqn: every env at its learner's turn")
    check(ts.grad_steps == 3 * config.update_per_collect, "greedy dqn: grad_steps")
    L = config.segment_len + config.n_step - 1
    log(json.dumps({"metric": "dqn_greedy_iteration", "device": smi,
                    "num_envs": config.num_envs, "learner_player": "both", "greedy_depth": 2,
                    "env_steps_per_sec": [config.num_envs * L / (r["iteration_ms"] / 1e3)
                                          for r in runs],
                    "runs": runs, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                    "seconds": time.perf_counter() - t0}))


def clone_tree(tree):
    """A deep copy of a payload: tensors cloned, containers rebuilt."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(v) for v in tree)
    return tree


def tree_equal(a, b, path="payload") -> int:
    """Checks ``a`` and ``b`` equal leaf for leaf (tensors by ``torch.equal``
    on the CPU); returns the number of tensors compared."""
    if isinstance(a, torch.Tensor):
        check(isinstance(b, torch.Tensor) and a.dtype == b.dtype
              and torch.equal(a.cpu(), b.cpu()), f"resume: {path} restored exactly")
        return 1
    if isinstance(a, dict):
        check(isinstance(b, dict) and a.keys() == b.keys(), f"resume: {path} keys")
        return sum(tree_equal(a[k], b[k], f"{path}.{k}") for k in a)
    if isinstance(a, (list, tuple)):
        check(len(a) == len(b), f"resume: {path} length")
        return sum(tree_equal(x, y, f"{path}[{i}]") for i, (x, y) in enumerate(zip(a, b)))
    check(a == b, f"resume: {path} == {b!r}")
    return 0


def phase_cli_resume(smi: str) -> None:
    """9. the DQN command line, relaunched from its full resume point."""
    from gobblet_rl_torch.examples import example_dqn
    from gobblet_rl_torch.train import checkpoint as ckpt

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        resume = os.path.join(tmp, "resume")
        saved, restored = {}, {}
        real_save, real_restore = ckpt.save_payload, ckpt.restore_payload

        def recording_save(directory, payload, step, meta=None):
            if directory == resume:
                saved[step] = (clone_tree(payload), meta)
            real_save(directory, payload, step, meta)

        def recording_restore(directory, step=None):
            payload, step = real_restore(directory, step)
            if payload is not None:
                restored[step] = clone_tree(payload)
            return payload, step

        def run(epochs: int):
            args = example_dqn.get_parser().parse_args(
                CLI_ARGS + ["--epoch", str(epochs), "--full-resume-dir", resume,
                            "--logdir", os.path.join(tmp, "log")])
            w0 = time.perf_counter()
            ts, history = example_dqn.main(args)
            return ts, history, time.perf_counter() - w0

        ckpt.save_payload, ckpt.restore_payload = recording_save, recording_restore
        try:
            ts1, hist1, s1 = run(1)
            ts2, hist2, s2 = run(2)
        finally:
            ckpt.save_payload, ckpt.restore_payload = real_save, real_restore
        check([h["epoch"] for h in hist1] == [0], "cli: the first launch runs epoch 0")
        check([h["epoch"] for h in hist2] == [1], "cli: the relaunch runs exactly epoch 1")
        check(ts2.grad_steps == 2 * ts1.grad_steps, "cli: grad_steps doubles")
        check(list(restored) == [0] and 0 in saved, "cli: step 0 saved and restored")
        tensors = tree_equal(restored[0], saved[0][0])
        check(ckpt.load_meta(resume, 0) == json.loads(json.dumps(saved[0][1])),
              "cli: meta sidecar restored")
        history = os.path.join(tmp, "log", "gobblet_rl_torch", "dqn", "history.jsonl")
        with open(history) as f:
            check(len(f.read().splitlines()) == 2, "cli: history.jsonl has both epochs")
    log(json.dumps({"metric": "dqn_cli_resume", "device": smi, "args": CLI_ARGS,
                    "first_launch_s": s1, "relaunch_s": s2, "grad_steps": ts2.grad_steps,
                    "restored_tensors_equal": tensors, "records": hist1 + hist2,
                    "seconds": time.perf_counter() - t0}))


def phase_vector(smi: str, gen: torch.Generator) -> None:
    """10. the vector env's rollout at full width."""
    from gobblet_rl_torch.env import vector
    from gobblet_rl_torch.ops import batched_core as bc

    t0 = time.perf_counter()
    dev = gen.device
    state, ts = vector.vector_reset(ROLLOUT_B, dev)
    state, ts, _ = vector.rollout(state, gen, ts, vector.random_policy, 4)  # warm-up
    (state, ts, stats), ms = timed(
        lambda: vector.rollout(state, gen, ts, vector.random_policy, ROLLOUT_STEPS), 1)
    eps, w1, w2 = (int(stats[k]) for k in ("episodes", "wins_p1", "wins_p2"))
    check(eps == w1 + w2, "vector: episodes == wins_p1 + wins_p2")
    check(ts.obs.dtype == torch.int8 and tuple(ts.obs.shape) == (ROLLOUT_B, 3, 3, 13),
          "vector: observation int8[B, 3, 3, 13]")
    check(ts.mask.dtype == torch.bool and tuple(ts.mask.shape) == (ROLLOUT_B, 54),
          "vector: mask bool[B, 54]")
    check(torch.equal(ts.mask, bc.legal_mask_planes(state.board, state.current).t()),
          "vector: mask == legal_mask_planes of the state")
    check(torch.equal(ts.obs, bc.to_reference_obs(bc.observe_planes_lm(state.board,
                                                                         state.current))),
          "vector: observation of the state")
    log(json.dumps({"metric": "vector_rollout_env_steps_per_sec", "device": smi,
                    "batch": ROLLOUT_B, "plies": ROLLOUT_STEPS,
                    "value": ROLLOUT_B * ROLLOUT_STEPS / (ms[0] / 1e3), "ms": ms[0],
                    "episodes": eps, "p1_share": w1 / eps,
                    "seconds": time.perf_counter() - t0}))


def phase_zoo(smi: str, gen: torch.Generator) -> None:
    """11. the committed dqn_greedy agent on the card."""
    from gobblet_rl_torch import zoo
    from gobblet_rl_torch.eval import tournament
    from gobblet_rl_torch.ops import batched_core as bc

    t0 = time.perf_counter()
    dev = gen.device
    net, _, entry = zoo.load("dqn_greedy", expect_family="dqn", device=dev)
    cpu_net, _, _ = zoo.load("dqn_greedy", device="cpu")
    state, _ = bc.rollout_random(bc.reset_planes(GREEDY_PARITY_B, dev), gen, 10)
    obs = bc.features_lm(state.board, state.current).t()
    with torch.no_grad():
        q_card, q_cpu = net(obs).cpu(), cpu_net(obs.cpu())
    tol = 2e-2 * float(q_cpu.abs().max())
    q_err = float((q_card - q_cpu).abs().max())
    check(q_err <= tol, f"zoo: Q on the card within {tol:.4g} of the CPU's")
    w0 = time.perf_counter()
    match = tournament.play_match(zoo.policy("dqn_greedy", device=dev),
                                  tournament.greedy_policy(2),
                                  num_games=ZOO_GAMES, seed=0, device=dev)
    match_s = time.perf_counter() - w0
    check(match["win_rate"] >= ZOO_MIN_WIN_RATE,
          f"zoo: dqn_greedy vs greedy-2 win rate {match['win_rate']:.3f} >= {ZOO_MIN_WIN_RATE}")
    log(json.dumps({"metric": "zoo_dqn_greedy_vs_greedy2", "device": smi, **match,
                    "manifest_vs_greedy_2": entry["metrics"]["vs_greedy-2"],
                    "q_positions": GREEDY_PARITY_B, "q_max_abs_err": q_err, "q_tolerance": tol,
                    "match_s": match_s, "seconds": time.perf_counter() - t0}))


def phase_search(smi: str, gen: torch.Generator) -> None:
    """12. the Gumbel search on the card against the CPU, then its time at
    the AlphaZero width."""
    from gobblet_rl_torch.models import actor_critic as ac
    from gobblet_rl_torch.ops import batched_core as bc
    from gobblet_rl_torch.search import gumbel, gumbel_lm

    t0 = time.perf_counter()
    dev = gen.device
    cfg = gumbel.GumbelConfig(num_sims=AZ["num_sims"])
    net = ac.ConvActorCritic(channels=AZ["channels"], blocks=AZ["blocks"], dtype=torch.float32,
                             device=dev)
    net.reset_parameters(gen)
    cpu_net = ac.ConvActorCritic(channels=AZ["channels"], blocks=AZ["blocks"],
                                 dtype=torch.float32, device="cpu")
    cpu_net.load_state_dict(net.state_dict())
    n = SEARCH_PARITY_B
    state, _ = bc.rollout_random(bc.reset_planes(n, dev), gen, 5)
    noise = bc.gumbel_field(gen, (54, n), dev)
    card = gumbel_lm.gumbel_search_lm(net, state.board, state.current, None, cfg, noise=noise)
    w0 = time.perf_counter()
    cpu = gumbel_lm.gumbel_search_lm(cpu_net, state.board.cpu(), state.current.cpu(), None, cfg,
                                     noise=noise.cpu())
    cpu_s = time.perf_counter() - w0
    same = (card[0].cpu() == cpu[0]) & (card[3].cpu() == cpu[3]).all(-1)
    share = float(same.float().mean())
    check(share >= SEARCH_MIN_SAME, f"search: {share:.4f} of roots identical on card and CPU "
          f">= {SEARCH_MIN_SAME}")
    mask = bc.legal_mask_planes(state.board, state.current)
    check(bool(mask[card[0].long(), torch.arange(n, device=dev)].all()),
          "search: every action legal")

    # time at the trainer's width and dtype (bf16 net): 1 warm-up, 2 timed
    B = AZ["num_envs"]
    net = ac.ConvActorCritic(channels=AZ["channels"], blocks=AZ["blocks"], device=dev)
    net.reset_parameters(gen)
    state, _ = bc.rollout_random(bc.reset_planes(B, dev), gen, 5)
    torch.cuda.reset_peak_memory_stats()
    _, ms = timed(lambda: gumbel_lm.gumbel_search_lm(net, state.board, state.current, gen, cfg), 3)
    timings = ms[1:]
    peak = torch.cuda.max_memory_allocated() / 2**30
    host_ms = statistics.median(timings)

    # the card's share of one call, against the unprofiled call time above
    profile_line = device_profile(
        lambda: gumbel_lm.gumbel_search_lm(net, state.board, state.current, gen, cfg), host_ms)
    log(json.dumps({"metric": "gumbel_search_ms", "device": smi, "batch": B,
                    "num_sims": cfg.num_sims, "net": f"conv {AZ['channels']}x{AZ['blocks']} bf16",
                    "ms": timings, "ms_per_sim": host_ms / cfg.num_sims,
                    "peak_mem_gib": peak, "profile": profile_line,
                    "cpu_parity_positions": n, "cpu_parity_same_share": share,
                    "cpu_parity_differing_roots": int((~same).sum()), "cpu_search_s": cpu_s,
                    "seconds": time.perf_counter() - t0}))


def device_profile(fn, host_ms: float) -> dict:
    """One call of ``fn`` under torch.profiler (CUPTI): its kernels' device
    time and count, against ``host_ms``, the same call's time unprofiled."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    kernels = [e for e in rows if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    return {
        "device_kernel_ms": busy_ms if busy_ms > 0 else "not measured",
        "device_kernels": sum(e.count for e in kernels),
        "self_device_ms_all_rows": sum(e.self_device_time_total for e in rows) / 1e3,
        "device_idle_share": 1 - busy_ms / host_ms if busy_ms > 0 else "not measured",
        "host_ops": sum(e.count for e in rows if e.device_type == torch.autograd.DeviceType.CPU),
        "top_kernels_ms": {e.key[:80]: e.device_time_total / 1e3
                           for e in sorted(kernels, key=lambda e: -e.device_time_total)[:6]},
    }


def check_segment(traj: dict, what: str) -> None:
    """A self-play segment's targets: pi is a distribution on the legal
    actions, and every finished game has a decisive winner."""
    pi, mask = traj["pi"], traj["mask"]
    check(bool((pi[~mask] == 0).all()) and bool((pi >= 0).all()),
          f"{what}: pi is 0 off the legal actions")
    check(float((pi.sum(-1) - 1).abs().max()) < 1e-5, f"{what}: each pi row sums to 1")
    done, winner = traj["done"], traj["winner"]
    check(bool(done.any()) and bool((winner[done] != 0).all()),
          f"{what}: every finished game has a decisive winner")


def phase_alphazero(smi: str, gen: torch.Generator) -> None:
    """13. the AlphaZero iteration at full width, split by phase, then
    ``alphazero.train`` with a full resume point, relaunched."""
    from gobblet_rl_torch.kernels import rollout as R
    from gobblet_rl_torch.train import alphazero
    from gobblet_rl_torch.train import checkpoint as ckpt

    t0 = time.perf_counter()
    config = alphazero.AZConfig(**AZ)
    R.rollout_random_fused.launches = 0
    torch.cuda.reset_peak_memory_stats()
    st = alphazero.init_alphazero(config, gen)
    it = alphazero.make_train_iteration(config)
    it(st, gen)                                      # warm-up
    torch.cuda.synchronize()
    before = {k: v.clone() for k, v in st.net.state_dict().items()}
    segments = []
    real_flatten = alphazero.flatten_segment

    def recording_flatten(traj, z, valid):
        segments.append(traj)
        return real_flatten(traj, z, valid)

    runs = []
    alphazero.flatten_segment = recording_flatten
    try:
        for _ in range(2):
            marks = []
            mark = cuda_mark(marks)
            w0 = time.perf_counter()
            mark("start")
            stats = it(st, gen, mark=mark)
            loss = float(stats["loss"])  # synchronises
            wall_s = time.perf_counter() - w0
            check(math.isfinite(loss), "alphazero: loss finite")
            phases = {name: prev.elapsed_time(event)
                      for (_, prev), (name, event) in zip(marks, marks[1:])}
            runs.append({"iteration_ms": 1e3 * wall_s, **{f"{k}_ms": v for k, v in phases.items()},
                         "loss": loss, "episodes": int(stats["episodes"]),
                         "valid_frac": float(stats["valid_frac"])})
    finally:
        alphazero.flatten_segment = real_flatten
    az_launches = R.rollout_random_fused.launches
    check(az_launches == 0, "alphazero: the path launches no rollout kernel")
    for traj in segments:
        check_segment(traj, "alphazero")
    check(any(not torch.equal(before[k], v) for k, v in st.net.state_dict().items()),
          "alphazero: the params changed")
    steps = config.num_envs * config.segment_len
    peak = torch.cuda.max_memory_allocated() / 2**30
    del st, segments

    # exact resume of train(), with the Gumbel search of the iteration above
    # and with PUCT (AZConfig's default search, root Dirichlet noise and
    # visit sampling drawn from the generator)
    resumes = {}
    real_save, real_restore = ckpt.save_payload, ckpt.restore_payload
    for search in ("gumbel_lm", "puct"):
        saved, restored, segments = {}, {}, []

        def recording_save(directory, payload, step, meta=None):
            saved[step] = clone_tree(payload)
            real_save(directory, payload, step, meta)

        def recording_restore(directory, step=None):
            payload, step = real_restore(directory, step)
            if payload is not None:
                restored[step] = clone_tree(payload)
            return payload, step

        def recording_flatten(traj, z, valid):
            segments.append(traj)
            return real_flatten(traj, z, valid)

        small = dict(AZ, num_envs=AZ_RESUME_ENVS, segment_len=AZ_RESUME_SEGMENT, search=search)
        ckpt.save_payload, ckpt.restore_payload = recording_save, recording_restore
        alphazero.flatten_segment = recording_flatten
        try:
            with tempfile.TemporaryDirectory() as tmp:
                resume = os.path.join(tmp, "resume")
                w0 = time.perf_counter()
                _, hist1 = alphazero.train(alphazero.AZConfig(**small, iterations=2),
                                           full_resume_dir=resume, device=gen.device)
                s1 = time.perf_counter() - w0
                w0 = time.perf_counter()
                _, hist2 = alphazero.train(alphazero.AZConfig(**small, iterations=3),
                                           full_resume_dir=resume, device=gen.device)
                s2 = time.perf_counter() - w0
        finally:
            ckpt.save_payload, ckpt.restore_payload = real_save, real_restore
            alphazero.flatten_segment = real_flatten
        what = f"alphazero train ({search})"
        check([h["iteration"] for h in hist1] == [0, 1], f"{what}: iterations 0 and 1")
        check([h["iteration"] for h in hist2] == [2], f"{what}: the relaunch runs iteration 2")
        check(list(restored) == [1] and 1 in saved, f"{what}: step 1 saved and restored")
        check(all(math.isfinite(h["loss"]) for h in hist1 + hist2), f"{what}: loss finite")
        check(len(segments) == 3, f"{what}: three segments")
        for traj in segments:
            check_segment(traj, what)
        resumes[search] = {"num_envs": AZ_RESUME_ENVS, "segment_len": AZ_RESUME_SEGMENT,
                           "first_launch_s": s1, "relaunch_s": s2,
                           "restored_tensors_equal": tree_equal(restored[1], saved[1]),
                           "records": hist1 + hist2}
    log(json.dumps({"metric": "az_train_iteration", "device": smi, **AZ,
                    "az_train_env_steps_per_sec": [steps / (r["iteration_ms"] / 1e3) for r in runs],
                    "sims_per_sec": [steps * config.num_sims / (r["iteration_ms"] / 1e3)
                                     for r in runs],
                    "runs": runs, "peak_mem_gib": peak, "rollout_kernel_launches": az_launches,
                    "resume": resumes, "seconds": time.perf_counter() - t0}))


def phase_az_zoo(smi: str, gen: torch.Generator) -> None:
    """14. the committed alphazero_gumbel32 agent on the card."""
    from gobblet_rl_torch import zoo
    from gobblet_rl_torch.eval import tournament
    from gobblet_rl_torch.ops import batched_core as bc

    t0 = time.perf_counter()
    dev = gen.device
    net, _, entry = zoo.load("alphazero_gumbel32", expect_family="alphazero", device=dev)
    cpu_net, _, _ = zoo.load("alphazero_gumbel32", device="cpu")
    state, _ = bc.rollout_random(bc.reset_planes(GREEDY_PARITY_B, dev), gen, 10)
    obs = bc.features_lm(state.board, state.current).t()
    errs = {}
    with torch.no_grad():
        for name, card, cpu in zip(("logits", "value"), net(obs), cpu_net(obs.cpu())):
            tol = 2e-2 * float(cpu.abs().max())
            errs[name] = (float((card.cpu() - cpu).abs().max()), tol)
            check(errs[name][0] <= tol, f"az zoo: {name} on the card within {tol:.4g} of the CPU's")
    policy = zoo.policy("alphazero_gumbel32", device=dev)
    long_games = {"calls": 0, "open": 0}

    def counted(generator, board, current):
        # play_match calls policy A once a ply of each half, which starts on
        # empty boards; the games without a winner at ply 50 run past it
        if not bool(board.any()):
            long_games["calls"] = 0
        if long_games["calls"] == AZ_ZOO_LONG_PLIES:
            long_games["open"] += int((bc.winner_planes(bc.flat_planes(board)) == 0).sum())
        long_games["calls"] += 1
        return policy(generator, board, current)

    w0 = time.perf_counter()
    match = tournament.play_match(counted, tournament.greedy_policy(2), num_games=AZ_ZOO_GAMES,
                                  seed=0, device=dev)
    match_s = time.perf_counter() - w0
    check(match["win_rate"] >= AZ_ZOO_MIN_WIN_RATE,
          f"az zoo: alphazero_gumbel32 vs greedy-2 win rate {match['win_rate']:.3f} >= "
          f"{AZ_ZOO_MIN_WIN_RATE}")
    log(json.dumps({"metric": "zoo_alphazero_gumbel32_vs_greedy2", "device": smi, **match,
                    "num_sims": entry["eval"]["num_sims"], "max_plies": 100,
                    "games_past_50_plies": long_games["open"],
                    "manifest_vs_greedy_2": entry["metrics"]["vs_greedy-2"],
                    "positions": GREEDY_PARITY_B,
                    "max_abs_err": {k: v[0] for k, v in errs.items()},
                    "tolerance": {k: v[1] for k, v in errs.items()},
                    "match_s": match_s, "seconds": time.perf_counter() - t0}))


def phase_ppo(smi: str, gen: torch.Generator) -> None:
    """15. the PPO iteration at full width, split by phase."""
    from gobblet_rl_torch.kernels import rollout as R
    from gobblet_rl_torch.train import ppo

    t0 = time.perf_counter()
    config = ppo.PPOConfig(**PPO)
    R.rollout_random_fused.launches = 0
    torch.cuda.reset_peak_memory_stats()
    st = ppo.init_ppo(config, gen)
    it = ppo.make_train_iteration(config, "self", device=gen.device)
    net, opt = st.nets[0], st.optimizers[0]
    st.env_states[0], _ = it(net, net, opt, st.env_states[0], gen, "both")   # warm-up
    torch.cuda.synchronize()
    before = {k: v.clone() for k, v in net.state_dict().items()}
    trajs, real_gae = [], ppo.compute_gae

    def recording_gae(traj, last_value, gamma, lam):
        trajs.append(traj)
        return real_gae(traj, last_value, gamma, lam)

    runs = []
    ppo.compute_gae = recording_gae
    try:
        for _ in range(3):
            marks = []
            mark = cuda_mark(marks)
            w0 = time.perf_counter()
            mark("start")
            st.env_states[0], stats = it(net, net, opt, st.env_states[0], gen, "both", mark=mark)
            loss = float(stats["loss"])  # synchronises
            wall_s = time.perf_counter() - w0
            check(math.isfinite(loss), "ppo: loss finite")
            check(int(stats["episodes"]) > 0, "ppo: episodes finished")
            phases = {name: prev.elapsed_time(event)
                      for (_, prev), (name, event) in zip(marks, marks[1:])}
            runs.append({"iteration_ms": 1e3 * wall_s, **{f"{k}_ms": v for k, v in phases.items()},
                         "loss": loss, "episodes": int(stats["episodes"]),
                         "mean_reward": float(stats["mean_reward"])})
    finally:
        ppo.compute_gae = real_gae

    def one_iteration():
        st.env_states[0], _ = it(net, net, opt, st.env_states[0], gen, "both")

    profile_line = device_profile(one_iteration,
                                  statistics.median(r["iteration_ms"] for r in runs))
    launches = R.rollout_random_fused.launches
    check(launches == 0, "ppo: the path launches no rollout kernel")
    for traj in trajs:
        picked = traj["mask"].gather(-1, traj["action"].long()[..., None])
        check(bool(picked.all()), "ppo: every recorded action legal")
    seats = ppo.seat_array("both", config.num_envs, gen.device)
    check(bool((st.env_states[0].current == seats).all()), "ppo: every env at its learner's turn")
    check(any(not torch.equal(before[k], v) for k, v in net.state_dict().items()),
          "ppo: the params changed")
    steps = config.num_envs * config.segment_len
    log(json.dumps({"metric": "ppo_train_iteration", "device": smi, **PPO,
                    "ppo_train_env_steps_per_sec": [steps / (r["iteration_ms"] / 1e3)
                                                    for r in runs],
                    "runs": runs, "profile": profile_line,
                    "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                    "rollout_kernel_launches": launches, "seconds": time.perf_counter() - t0}))


def phase_ppo_league(smi: str, gen: torch.Generator) -> None:
    """16. the ppo_league recipe at its width: the bank, each leg, the CLI
    relaunched, and the DQN iteration with the defense term."""
    from gobblet_rl_torch.examples import example_ppo
    from gobblet_rl_torch.train import checkpoint as ckpt
    from gobblet_rl_torch.train import defense, dqn, ppo, replay

    t0 = time.perf_counter()
    dev = gen.device
    config = ppo.PPOConfig(**LEAGUE)
    w0 = time.perf_counter()
    raw = defense.generate_defense_bank(num_games=config.defense_bank_games, seed=config.seed,
                                        depth=config.defense_bank_depth,
                                        sides=config.defense_bank_sides, device=dev)
    bank_s = time.perf_counter() - w0
    rows = len(raw["action"])
    check(bool(raw["mask"][range(rows), raw["action"]].all()), "league: every label legal")
    bank = defense.bank_tensors(raw, dev)

    # one iteration of each leg; "pool" is the "self" rollout against a
    # frozen snapshot
    st = ppo.init_ppo(config, gen)
    net, opt = st.nets[0], st.optimizers[0]
    snapshot = ppo.make_net(config, dev)
    snapshot.load_state_dict(ppo.snapshot(net))
    legs = {}
    for leg, kind, opp in (("random", "random", net), ("greedy", "greedy", net),
                           ("pool", "self", snapshot), ("search", "search", net)):
        it = ppo.make_train_iteration(config, kind, bank, dev)
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        st.env_states[0], stats = it(net, opp, opt, st.env_states[0], gen, "both")
        loss = float(stats["loss"])  # synchronises
        legs[leg] = {"iteration_s": time.perf_counter() - w0, "loss": loss,
                     "episodes": int(stats["episodes"])}
        check(math.isfinite(loss), f"league: {leg} leg loss finite")
    del st, snapshot

    # the command line, relaunched from its resume point
    with tempfile.TemporaryDirectory() as tmp:
        resume = os.path.join(tmp, "resume")
        saved, restored = {}, {}
        real_save, real_restore = ckpt.save_payload, ckpt.restore_payload

        def recording_save(directory, payload, step, meta=None):
            saved[step] = clone_tree(payload)
            real_save(directory, payload, step, meta)

        def recording_restore(directory, step=None):
            payload, step = real_restore(directory, step)
            if payload is not None:
                restored[step] = clone_tree(payload)
            return payload, step

        def run(iterations: int):
            args = example_ppo.get_parser().parse_args(
                LEAGUE_ARGS + ["--iterations", str(iterations), "--checkpoint-dir", resume,
                               "--logdir", os.path.join(tmp, "log")])
            w0 = time.perf_counter()
            _, history = example_ppo.main(args)
            return history, time.perf_counter() - w0

        ckpt.save_payload, ckpt.restore_payload = recording_save, recording_restore
        try:
            hist1, s1 = run(2)
            hist2, s2 = run(3)
        finally:
            ckpt.save_payload, ckpt.restore_payload = real_save, real_restore
        check([h["iteration"] for h in hist1] == [0, 1], "league cli: iterations 0 and 1")
        check([h["iteration"] for h in hist2] == [2], "league cli: the relaunch runs iteration 2")
        check(all(math.isfinite(h["loss"]) for h in hist1 + hist2), "league cli: loss finite")
        check(list(restored) == [1] and 1 in saved, "league cli: step 1 saved and restored")
        tensors = tree_equal(restored[1], saved[1])
        history = os.path.join(tmp, "log", "gobblet_rl_torch", "ppo", "history.jsonl")
        with open(history) as f:
            check(len(f.read().splitlines()) == 3, "league cli: history.jsonl has 3 iterations")

    # phase 5's DQN iteration with the defense term (DQNConfig's bank)
    dconfig = dqn.DQNConfig(**DQN, defense_bc_weight=1.0)
    w0 = time.perf_counter()
    dbank = defense.bank_tensors(defense.generate_defense_bank(
        num_games=dconfig.defense_bank_games, seed=dconfig.seed,
        depth=dconfig.defense_bank_depth, device=dev), dev)
    dqn_bank_s = time.perf_counter() - w0
    ts = dqn.init_train_state(dconfig, dqn.make_net(dconfig, dev), gen)
    it, opp_fn = dqn.make_train_iteration(dconfig, dbank)
    env_state = dqn.init_env_state(dconfig, opp_fn, ts.opponent_net, gen)
    buffer = replay.make_buffer(dconfig.buffer_size, dev)
    w0 = time.perf_counter()
    env_state, buffer, loss = it(ts, env_state, buffer, gen)
    dqn_loss = float(loss)  # synchronises
    dqn_s = time.perf_counter() - w0
    check(math.isfinite(dqn_loss), "dqn with the defense term: loss finite")
    del ts, env_state, buffer
    log(json.dumps({"metric": "ppo_league_recipe", "device": smi, **LEAGUE,
                    "bank_host_s": bank_s, "bank_rows": rows, "legs": legs,
                    "cli_first_launch_s": s1, "cli_relaunch_s": s2,
                    "restored_tensors_equal": tensors, "records": hist1 + hist2,
                    "dqn_bank_host_s": dqn_bank_s, "dqn_bank_rows": int(dbank["action"].numel()),
                    "dqn_defense_iteration_s": dqn_s, "dqn_defense_loss": dqn_loss,
                    "seconds": time.perf_counter() - t0}))


def phase_ppo_zoo(smi: str, gen: torch.Generator) -> None:
    """17. the committed ppo_league agent on the card, and its defense
    against the exact solver."""
    from gobblet_rl_torch import zoo
    from gobblet_rl_torch.eval import tournament
    from gobblet_rl_torch.native import engine
    from gobblet_rl_torch.ops import batched_core as bc

    t0 = time.perf_counter()
    dev = gen.device
    net, _, entry = zoo.load("ppo_league", expect_family="ppo", device=dev)
    cpu_net, _, _ = zoo.load("ppo_league", device="cpu")
    state, _ = bc.rollout_random(bc.reset_planes(GREEDY_PARITY_B, dev), gen, 10)
    obs = bc.features_lm(state.board, state.current).t()
    errs = {}
    with torch.no_grad():
        for name, card, cpu in zip(("logits", "value"), net(obs), cpu_net(obs.cpu())):
            tol = 2e-2 * float(cpu.abs().max())
            errs[name] = (float((card.cpu() - cpu).abs().max()), tol)
            check(errs[name][0] <= tol,
                  f"ppo zoo: {name} on the card within {tol:.4g} of the CPU's")
    w0 = time.perf_counter()
    match = tournament.play_match(zoo.policy("ppo_league", device=dev),
                                  tournament.greedy_policy(2), num_games=ZOO_GAMES, seed=0,
                                  device=dev)
    match_s = time.perf_counter() - w0
    check(match["win_rate"] >= PPO_ZOO_MIN_WIN_RATE,
          f"ppo zoo: ppo_league vs greedy-2 win rate {match['win_rate']:.3f} >= "
          f"{PPO_ZOO_MIN_WIN_RATE}")

    # the audit with the solver's host calls timed apart
    solver = {"calls": 0, "s": 0.0}

    def timed_solver(fn):
        def wrapped(*args):
            w = time.perf_counter()
            out = fn(*args)
            solver["calls"] += 1
            solver["s"] += time.perf_counter() - w
            return out
        return wrapped

    def solve_fn(board27, player):
        res = engine.solve(board27, player=player, max_depth=AUDIT_DEPTH)
        return res["proven"], res["mate_in"]

    real_batch = engine.solve_batch
    engine.solve_batch = timed_solver(real_batch)
    try:
        w0 = time.perf_counter()
        audit = tournament.defense_audit(zoo.policy("ppo_league", device=dev),
                                         num_games=AUDIT_GAMES, depth=AUDIT_DEPTH,
                                         solve_fn=timed_solver(solve_fn), device=dev)
        audit_s = time.perf_counter() - w0
    finally:
        engine.solve_batch = real_batch
    check(audit["ungraded_games"] == 0, "ppo zoo: every audited move graded")

    # the oracle picks among equally fast wins by its salt and by what its
    # transposition table holds, and so the lines the defense is tested on:
    # the same audit against oracles of fixed salts, each from a cleared
    # table (then the answers equal the JAX package's for the same salt)
    def fixed_salt_oracle(salt):
        def fn(_, board, current):
            boards = board.permute(2, 0, 1).reshape(-1, 27).cpu().numpy()
            actions = engine.solve_batch(boards, current.cpu().numpy().astype("int32"),
                                         AUDIT_DEPTH, salt)
            return torch.from_numpy(actions).to(board.device)
        return fn

    by_salt = {}
    for salt, want in AUDIT_BY_SALT.items():
        engine.solve_tt_clear()
        res = tournament.defense_audit(zoo.policy("ppo_league", device=dev),
                                       num_games=AUDIT_GAMES, depth=AUDIT_DEPTH,
                                       oracle_policy=fixed_salt_oracle(salt), device=dev)
        by_salt[salt] = [res["mean_plies_survived"], res["mistakes_per_game"]]
        check(res["ungraded_games"] == 0, f"ppo zoo: salt {salt}: every audited move graded")
        check(tuple(by_salt[salt]) == want,
              f"ppo zoo: salt {salt}: (plies, mistakes) {tuple(by_salt[salt])} == {want}")
    log(json.dumps({"metric": "zoo_ppo_league", "device": smi, **match,
                    "manifest_vs_greedy_2": entry["metrics"]["vs_greedy-2"],
                    "positions": GREEDY_PARITY_B,
                    "max_abs_err": {k: v[0] for k, v in errs.items()},
                    "tolerance": {k: v[1] for k, v in errs.items()}, "match_s": match_s,
                    "audit": audit, "audit_depth": AUDIT_DEPTH,
                    "manifest_plies_survived": entry["metrics"]["defense_plies_survived"],
                    "audit_s": audit_s, "audit_solver_host_s": solver["s"],
                    "audit_solver_calls": solver["calls"],
                    "audit_rest_s": audit_s - solver["s"],
                    "plies_and_mistakes_by_oracle_salt": by_salt,
                    "solver_library": engine.build().name,
                    "seconds": time.perf_counter() - t0}))


def exact_value_nets(dev: torch.device):
    """A plain-headed ``QNet`` and an ``MLPActorCritic`` in float32 with one
    hidden layer of 64 and every weight and bias a multiple of 2^-6 with a
    numerator in [-16, 16] (on 0/1 inputs every dot product is exact), each
    on the CPU and on ``dev`` with the same weights."""
    from gobblet_rl_torch.models import actor_critic as ac
    from gobblet_rl_torch.models.mlp import QNet

    rng = torch.Generator().manual_seed(0)
    pairs = []
    for make in (lambda d: QNet(hidden_sizes=(64,), dtype=torch.float32, device=d),
                 lambda d: ac.MLPActorCritic(hidden_sizes=(64,), dtype=torch.float32, device=d)):
        cpu = make("cpu")
        with torch.no_grad():
            for p in cpu.parameters():
                p.copy_(torch.randint(-16, 17, p.shape, generator=rng) / 64)
        card = make(dev)
        card.load_state_dict(cpu.state_dict())
        pairs.append((cpu, card))
    return pairs


def phase_value_search(smi: str, gen: torch.Generator) -> None:
    """18. the value search on the card against the CPU, then the zoo
    entrants' time and peak memory."""
    from gobblet_rl_torch.ops import batched_core as bc
    from gobblet_rl_torch.policies import value_search as vs

    t0 = time.perf_counter()
    dev = gen.device
    (q_cpu, q_card), (ac_cpu, ac_card) = exact_value_nets(dev)
    n = VS_PARITY_B
    state, _ = bc.rollout_random(bc.reset_planes(n, dev), gen, VS_PARITY_PLIES)
    board, cur = state.board, state.current
    field = bc.gumbel_field(gen, (54, n), dev)
    heads = {"dqn": (vs.dqn_value_fn(q_card), vs.dqn_value_fn(q_cpu)),
             "az": (vs.az_value_fn(ac_card), vs.az_value_fn(ac_cpu))}
    parity = {}
    for head, (vf_card, vf_cpu) in heads.items():
        for depth, solve in ((1, True), (2, False), (2, True)):
            what = f"value search {head} depth {depth} solve {solve}"
            card = vs.make_value_search(vf_card, depth, solve)(None, board, cur, gumbel=field)
            cpu = vs.make_value_search(vf_cpu, depth, solve)(None, board.cpu(), cur.cpu(),
                                                             gumbel=field.cpu())
            same = card.cpu() == cpu
            if head == "dqn":
                check(bool(same.all()), f"{what}: card == CPU (tolerance 0)")
                parity[f"{head}_d{depth}_{int(solve)}"] = {"positions": n, "differing": 0}
                continue
            score = vs.search_scores(vf_card, board, cur, depth, solve)
            top2 = (score + 1e-5 * field).topk(2, dim=0).values
            clear = (top2[0] - top2[1] > 1e-6).cpu()
            check(bool(same[clear].all()), f"{what}: card == CPU where the top two differ "
                  f"by more than 1e-6")
            parity[f"{head}_d{depth}_{int(solve)}"] = {
                "positions": n, "compared": int(clear.sum()), "not_compared": int((~clear).sum()),
                "differing_of_not_compared": int((~same[~clear]).sum())}
    # the actor-critic's leaf values on every depth-2 leaf of 8 positions
    b8, c8 = board[..., :8], cur[:8]
    leaves = vs._fold_actions(vs._fold_actions(b8, c8), (1 - c8).repeat(54))
    us = c8.repeat(54 * 54)
    leaf_err = float((heads["az"][0](leaves, us).cpu()
                      - heads["az"][1](leaves.cpu(), us.cpu())).abs().max())
    check(leaf_err <= 1e-6, f"value search: az leaf values within 1e-6 ({leaf_err:.3g})")
    parity_s = time.perf_counter() - t0

    timings = {}
    for name in ("alphazero_gumbel32", "dqn_greedy"):
        policy = vs.zoo_search_policy(name, device=dev)
        for B in VS_TIMING_B:
            state, _ = bc.rollout_random(bc.reset_planes(B, dev), gen, VS_PARITY_PLIES)
            b, c = state.board, state.current
            del state
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            timed(lambda: policy(gen, b, c), 1)
            actions, ms = timed(lambda: policy(gen, b, c), 3)
            peak = torch.cuda.max_memory_allocated() / 2**30
            legal = bc.legal_mask_planes(b, c)[actions.long(), torch.arange(B, device=dev)]
            check(bool(legal.all()), f"{name}+search2 at B={B}: every action legal")
            if B >= 1024:
                check(peak <= VS_MAX_PEAK_GIB,
                      f"{name}+search2 at B={B}: peak {peak:.2f} GiB <= {VS_MAX_PEAK_GIB}")
            timings[f"{name}+search2 B={B}"] = {
                "ms": ms, "ms_median": statistics.median(ms), "peak_mem_gib": peak,
                "allocated_before_gib": base / 2**30,
                "candidates_per_chunk": vs.candidate_chunk(B, 2, True)}
    log(json.dumps({"metric": "value_search", "device": smi, "parity_positions": n,
                    "parity": parity, "az_leaf_max_abs_err": leaf_err, "parity_s": parity_s,
                    "fold_lanes": vs.FOLD_LANES, "net_lanes": vs.NET_LANES,
                    "timings": timings, "seconds": time.perf_counter() - t0}))


def phase_tournament(smi: str, gen: torch.Generator) -> None:
    """19. the tournament command line, then the AZ search entrant against
    the exact solver."""
    from gobblet_rl_torch.eval import tournament
    from gobblet_rl_torch.examples import example_tournament
    from gobblet_rl_torch.policies import value_search as vs

    t0 = time.perf_counter()
    args = example_tournament.get_parser().parse_args(TOURNAMENT_ARGS + ["--device",
                                                                         str(gen.device)])
    res = example_tournament.main(args)
    cli_s = time.perf_counter() - t0
    for pair, m in res["pairs"].items():
        check(m["wins"] + m["losses"] + m["undecided"] == m["games"] == args.games,
              f"tournament: {pair} accounts for its games")
    elo = {k: v["elo"] for k, v in res["standings"].items()}
    for entrant in ("dqn_greedy+search2", "alphazero_gumbel32+search2"):
        check(elo[entrant] > elo["greedy-2"], f"tournament: {entrant} above greedy-2 ({elo})")
    check(elo["greedy-2"] > elo["random"], f"tournament: greedy-2 above random ({elo})")

    w0 = time.perf_counter()
    match = tournament.play_match(vs.zoo_search_policy("alphazero_gumbel32", device=gen.device),
                                  tournament.solver_policy(depth=15), num_games=SOLVER_GAMES,
                                  seed=0, swap_colors=False, max_plies=SOLVER_MAX_PLIES,
                                  device=gen.device)
    solver_s = time.perf_counter() - w0
    check(match["losses"] == 0 and match["win_rate"] >= SOLVER_MIN_WIN_RATE,
          f"tournament: alphazero_gumbel32+search2 vs solver-15 {match}")
    log(json.dumps({"metric": "tournament_cli", "device": smi, "args": TOURNAMENT_ARGS,
                    "standings": res["standings"], "pairs": res["pairs"], "cli_s": cli_s,
                    "tpu_round_elo_context": TPU_ROUND_ELO,
                    "search2_vs_solver15": match, "search2_vs_solver15_s": solver_s,
                    "seconds": time.perf_counter() - t0}))


def phase_env_api(smi: str, gen: torch.Generator) -> None:
    """20. the per-env functional API against the lane-major engine."""
    from gobblet_rl_torch.core import env as fenv
    from gobblet_rl_torch.core import rules
    from gobblet_rl_torch.ops import batched_core as bc
    from gobblet_rl_torch.ops import debug

    t0 = time.perf_counter()
    dev = gen.device
    B = API_B
    es = fenv.batched_reset(B, dev)
    ps = bc.reset_planes(B, dev)
    env_ms, planes_ms, arbitrary, illegal = [], [], 0, 0
    for ply in range(API_PLIES):
        mask = bc.legal_mask_planes(ps.board, ps.current)
        check(torch.equal(rules.batched_legal_mask(es.board, es.current), mask.t()),
              f"env api: ply {ply}: batched_legal_mask == legal_mask_planes")
        if ply % API_ARBITRARY_EVERY == API_ARBITRARY_EVERY - 1:
            actions = torch.randint(0, 54, (B,), generator=gen, device=dev, dtype=torch.int32)
            arbitrary += 1
            illegal += int((~mask[actions.long(), torch.arange(B, device=dev)] & ~ps.done).sum())
        else:
            actions = bc.sample_random_lm(gen, mask)
        es, ms = timed(lambda: fenv.batched_step_strict(es, actions), 1)
        env_ms += ms
        ps, ms = timed(lambda: bc.step_planes(ps, actions), 1)
        planes_ms += ms
        same = (torch.equal(es.board, ps.board.permute(2, 0, 1))
                and torch.equal(es.rewards, ps.rewards.t())
                and all(torch.equal(getattr(es, f), getattr(ps, f))
                        for f in ("current", "turn", "done", "winner", "last_action")))
        check(same, f"env api: ply {ply}: batched_step_strict == step_planes (tolerance 0)")
        check(bool(debug.state_invariants(ps).all()), f"env api: ply {ply}: invariants hold")
    done = int(ps.done.sum())
    bad = ps.board.clone()
    bad[1, 0, 0], bad[1, 5, 0] = 3, 3                # piece 3 twice on its level
    try:
        debug.checked_step(ps._replace(board=bad), bc.sample_random_lm(gen, mask))
        raised = None
    except ValueError as e:
        raised = str(e)
    check(raised == "pre-step state invalid", f"env api: checked_step raises ({raised})")
    log(json.dumps({"metric": "env_api", "device": smi, "batch": B, "plies": API_PLIES,
                    "arbitrary_plies": arbitrary, "illegal_live_actions": illegal,
                    "finished_games": done, "batched_step_strict_ms_per_ply":
                    statistics.median(env_ms), "step_planes_ms_per_ply":
                    statistics.median(planes_ms), "checked_step_raised": raised,
                    "seconds": time.perf_counter() - t0}))


def host_game(agents: dict, ab_seat: int, record: dict) -> int:
    """One game on the port's board between ``agents`` (seat -> host agent),
    observations by ``observe_np``: every action legal; appends the ms of
    each move to ``record["alphabeta"]`` or ``record["agent"]``, and each of
    the agent's positions to ``record["positions"]``.  Returns the winner
    (0 if capped)."""
    from gobblet_rl_torch.board import Board
    from gobblet_rl_torch.core import observe

    board, player = Board(), 0
    for _ in range(HOST_MAX_PLIES):
        grid = board._grid()
        obs, mask = observe.observe_np(grid, player, player)
        w0 = time.perf_counter()
        action = agents[player].compute_action(obs, mask)
        record["alphabeta" if player == ab_seat else "agent"].append(
            1e3 * (time.perf_counter() - w0))
        check(mask[action] == 1, f"host agents: action {action} legal")
        if player != ab_seat:
            record["positions"].append((obs, mask, grid, player, action))
        board.play_turn(player, action)
        winner = board.check_for_winner()
        if winner:
            return winner
        player = 1 - player
    return 0


def phase_host_agents(smi: str, gen: torch.Generator) -> None:
    """21. the host surface's agents on the card."""
    from gobblet_rl_torch import zoo
    from gobblet_rl_torch.core import observe, rules_np
    from gobblet_rl_torch.examples.example_alphazero import SearchAgentPolicy
    from gobblet_rl_torch.native import engine
    from gobblet_rl_torch.ops import batched_core as bc
    from gobblet_rl_torch.policies import AlphaBetaGobbletPolicy
    from gobblet_rl_torch.utils import profiling

    t0 = time.perf_counter()
    dev = gen.device

    # the native engine against the rules on the depth-2 tree
    eng = engine.NativeEngine()
    boards = {}
    root = rules_np.empty_board()
    for a1 in range(54):
        b1 = rules_np.apply_action(root, 0, a1)
        for a2 in np.flatnonzero(rules_np.legal_mask(b1, 1)):
            b2 = rules_np.apply_action(b1, 1, int(a2))
            boards[b2.tobytes()] = b2
    for board in boards.values():
        eng.board[:] = board.reshape(27)
        for player in (0, 1):
            check(np.array_equal(eng.legal_mask(player), rules_np.legal_mask(board, player)),
                  "native engine: legal mask == rules_np on the depth-2 tree")
        check(eng.winner() == rules_np.line_winner(board),
              "native engine: winner == rules_np on the depth-2 tree")
    check(len(boards) > 2500, f"native engine: {len(boards)} boards in the depth-2 tree")
    wins0, winners = eng.play_match(200, 2, 0)
    decided = int((winners != 0).sum())
    check(decided > 0 and wins0 / decided > 0.9,
          f"native engine: greedy-2 wins {wins0} of {decided} decided games > 0.9")
    native_s = time.perf_counter() - t0

    # the DQN and PPO host agents against alpha-beta, card against CPU
    agents_line = {}
    for name in ("dqn_greedy", "ppo_league"):
        card = zoo.host_agent(name, seed=0, device=dev)
        record = {"agent": [], "alphabeta": [], "positions": []}
        results = []
        for ab_seat in (1, 0):
            for g in range(HOST_GAMES_PER_SEAT):
                ab = AlphaBetaGobbletPolicy(depth=HOST_AB_DEPTH, seed=100 * ab_seat + g)
                seats = {ab_seat: ab, 1 - ab_seat: card}
                results.append(host_game(seats, ab_seat, record) * (1 if ab_seat else -1))
        net, _, entry = zoo.load(name, device="cpu")
        cpu_agent = zoo.host_agent(name, seed=0, device="cpu")
        positions = record["positions"]
        grids = torch.from_numpy(np.stack([p[2] for p in positions], -1))
        players = torch.tensor([p[3] for p in positions], dtype=torch.int32)
        with torch.no_grad():
            out = net(bc.features_lm(grids, players).t())
        values = (out[0] if entry["family"] == "ppo" else out).float().numpy()
        masks = np.stack([p[1] for p in positions]).astype(bool)
        scale = np.abs(np.where(masks, values, 0)).max(1)
        top2 = np.sort(np.where(masks, values, -np.inf), 1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 2 * HOST_TOL * scale
        same = [cpu_agent.compute_action(p[0], p[1]) == p[4] for p in positions]
        compared = int(clear.sum())
        check(all(s for s, c in zip(same, clear) if c),
              f"host agents: {name} on the card == on the CPU where the values are apart")
        agents_line[name] = {
            "games": len(results), "agent_wins": sum(r > 0 for r in results),
            "alphabeta_wins": sum(r < 0 for r in results),
            "capped": sum(r == 0 for r in results), "moves": len(positions),
            "agent_ms_per_move_median": statistics.median(record["agent"]),
            "alphabeta_ms_per_move_median": statistics.median(record["alphabeta"]),
            "cpu_compared_positions": compared, "cpu_same_all_positions": int(sum(same))}

    # the AlphaZero host agent and SearchAgentPolicy: 1 warm-up, timed moves
    # (the opening, then the positions after 1, 2 and 3 plies)
    board, player = rules_np.empty_board(), 0
    az_positions = []
    for a in (49, 0, 20, None):
        az_positions.append(observe.observe_np(board, player, player))
        if a is not None:
            board, player = rules_np.apply_action(board, player, a), 1 - player
    net, _, entry = zoo.load("alphazero_gumbel32", device=dev)
    az_agents = {   # the host agent at the manifest's simulations
        "host_agent": zoo.host_agent("alphazero_gumbel32", seed=0, device=dev),
        "search_agent": SearchAgentPolicy(net, num_sims=HOST_AZ_SIMS, seed=0, device=dev),
    }
    az_ms = {}
    for key, agent in az_agents.items():
        az_ms[key] = []
        for obs, mask in az_positions[:1 + HOST_AZ_MOVES]:
            w0 = time.perf_counter()
            action = agent.compute_action(obs, mask)
            az_ms[key].append(1e3 * (time.perf_counter() - w0))
            check(mask[action] == 1, f"host agents: {key} action legal")
        az_ms[key] = az_ms[key][1:]
    host_ms = statistics.median(az_ms["search_agent"])

    # one profiled SearchAgentPolicy move, through the port's trace helper
    # (read from the Chrome trace: key_averages() takes tens of seconds on
    # the ~10^5 events of a 128-simulation move)
    obs, mask = az_positions[-1]
    with tempfile.TemporaryDirectory() as logdir:
        w0 = time.perf_counter()
        with profiling.trace(logdir):
            with profiling.annotate("host_search_move"):
                action = az_agents["search_agent"].compute_action(obs, mask)
        trace_s = time.perf_counter() - w0
        files = sorted(Path(logdir).glob("trace-*.json"))
        check(len(files) == 1, "host agents: the trace wrote one file")
        trace_mib = files[0].stat().st_size / 2**20
        events = json.loads(files[0].read_text())["traceEvents"]
    check(mask[action] == 1, "host agents: the profiled move is legal")
    check(any(e.get("name") == "host_search_move" for e in events),
          "host agents: the trace names the annotation")
    kernels = [e for e in events if e.get("cat") == "kernel"]
    busy_ms = sum(e["dur"] for e in kernels) / 1e3
    by_name = collections.Counter()
    for e in kernels:
        by_name[e["name"][:80]] += e["dur"] / 1e3
    profile_line = {
        "device_kernel_ms": busy_ms if busy_ms > 0 else "not measured",
        "device_kernels": len(kernels),
        "device_idle_share": 1 - busy_ms / host_ms if busy_ms > 0 else "not measured",
        "unprofiled_move_ms": host_ms, "trace_s": trace_s, "trace_mib": trace_mib,
        "top_kernels_ms": dict(by_name.most_common(6)),
    }
    log(json.dumps({"metric": "host_agents", "device": smi,
                    "native_depth2_boards": len(boards), "native_greedy2_vs_random":
                    {"wins_p0": wins0, "decided": decided, "games": 200},
                    "native_s": native_s, "alphabeta_depth": HOST_AB_DEPTH,
                    "agents": agents_line, "az_host_agent_sims": entry["eval"]["num_sims"],
                    "search_agent_sims": HOST_AZ_SIMS,
                    "az_host_agent_ms": az_ms["host_agent"],
                    "search_agent_ms": az_ms["search_agent"],
                    "profiled_move": profile_line,
                    "seconds": time.perf_counter() - t0}))


def trees_equal(a, b) -> bool:
    """Leaf for leaf ``torch.equal`` of two sequences (plain values by ==)."""
    return all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y for x, y in zip(a, b))


def nets_equal(a: torch.nn.Module, b: torch.nn.Module) -> bool:
    return trees_equal(a.state_dict().values(), b.state_dict().values())


def exact_linear_ppo(dev: torch.device):
    """(net, opponent) ``MLPActorCritic`` without a hidden layer, float32,
    every weight a multiple of 2^-6 with a numerator in [-16, 16], on ``dev``
    (the same weights on every device)."""
    from gobblet_rl_torch.models import actor_critic as ac

    rng = torch.Generator().manual_seed(1)
    nets = []
    for _ in range(2):
        cpu = ac.MLPActorCritic(hidden_sizes=(), dtype=torch.float32, device="cpu")
        with torch.no_grad():
            for p in cpu.parameters():
                p.copy_(torch.randint(-16, 17, p.shape, generator=rng) / 64)
        net = ac.MLPActorCritic(hidden_sizes=(), dtype=torch.float32, device=dev)
        net.load_state_dict(cpu.state_dict())
        nets.append(net)
    return nets


def small_ppo_case():
    """The injected draws and the start state of the card-vs-CPU PPO check,
    numpy, from one seed."""
    from gobblet_rl_torch.train import ppo

    cfg = ppo.PPOConfig(**PAR_PPO_SMALL)
    rng = np.random.default_rng(0)
    L, B = cfg.segment_len, cfg.num_envs
    noise = {k: rng.gumbel(size=(L, B, 54)).astype(np.float32) for k in ("act", "opp", "open")}
    perms = [rng.permutation(L * B) for _ in range(cfg.epochs_per_iter)]
    net, opp = exact_linear_ppo(torch.device("cpu"))
    gen = torch.Generator().manual_seed(2)
    env = ppo.init_env_state(cfg, ppo.make_opponent_fn(cfg, device="cpu"), opp, gen,
                             cfg.learner_player)
    return {"noise": noise, "perms": perms, "env": [x.numpy() for x in env]}


def run_small_ppo(case, dev: torch.device) -> dict:
    """One sharded PPO iteration (world size 1) on ``dev`` under the case's
    draws; the params after it."""
    from gobblet_rl_torch.ops import batched_core as bc
    from gobblet_rl_torch.parallel import mesh as mesh_mod
    from gobblet_rl_torch.parallel import sharded_ppo
    from gobblet_rl_torch.train import ppo

    cfg = ppo.PPOConfig(**PAR_PPO_SMALL)
    net, opp = exact_linear_ppo(dev)
    it = sharded_ppo.make_sharded_ppo_iteration(cfg, mesh_mod.make_mesh(device=dev), dev)
    env = bc.PlanesState(*(torch.from_numpy(x).to(dev) for x in case["env"]))
    it(net, opp, ppo.make_optimizer(cfg, net), env, None, cfg.learner_player,
       noise={k: torch.from_numpy(v).to(dev) for k, v in case["noise"].items()},
       perms=[torch.from_numpy(p).to(dev) for p in case["perms"]])
    return {k: v.detach().cpu() for k, v in net.state_dict().items()}


def cpu_ppo_rank(rank, world, dev, case):
    """The CPU side of the card-vs-CPU PPO check, on a gloo rank."""
    return run_small_ppo(case, dev)


def tp_census_rank(rank, world, dev, batch):
    """On two ranks of one card: a TP forward and step of the dueling QNet
    on a (1 x 2) mesh against the replicated net, then the census and the
    layout of one DP iteration of the DQN on a (2 x 1) mesh."""
    from gobblet_rl_torch.models.mlp import QNet
    from gobblet_rl_torch.ops import batched_core as bc
    from gobblet_rl_torch.parallel import collective_audit as ca
    from gobblet_rl_torch.parallel import mesh as mesh_mod
    from gobblet_rl_torch.parallel import sharded_train
    from gobblet_rl_torch.parallel import tensor_parallel as tp
    from gobblet_rl_torch.train import dqn, replay

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    obs = (torch.rand((batch, 117), generator=gen, device=dev) < 0.2).to(torch.int8)
    mask = torch.rand((batch, 54), generator=gen, device=dev) < 0.7
    target = torch.randn((batch, 54), generator=gen, device=dev)
    net = QNet(dueling=True, dtype=torch.float32, device=dev)
    net.reset_parameters(gen)
    tp_net = tp.shard_params_tp(net, mesh_mod.make_mesh(model_parallel=world, device=dev))
    with torch.no_grad():
        (q_tp, q_tp_ms), (q_rep, q_rep_ms) = timed(lambda: tp_net(obs), 3), timed(
            lambda: net(obs), 3)
    # SGD, so the params after the step differ as the gradients do (Adam's
    # first step divides each by its own size)
    step = tp.make_tp_train_step(tp_net, torch.optim.SGD(tp_net.parameters(), lr=1e-2),
                                 mesh_mod.make_mesh(model_parallel=world, device=dev))
    loss = float(step(obs, mask, target))
    optimizer = torch.optim.SGD(net.parameters(), lr=1e-2)
    rep_loss = ((torch.where(mask, net(obs), 0.0) - target) ** 2).mean()
    rep_loss.backward()
    optimizer.step()
    rep_loss = rep_loss.item()
    full, rep = tp_net.full_state_dict(), net.state_dict()
    out = {"tp_forward_err": float((q_tp - q_rep).abs().max()),
           "tp_forward_ms": statistics.median(q_tp_ms), "forward_ms": statistics.median(q_rep_ms),
           "tp_step_loss_err": abs(loss - rep_loss),
           "tp_step_param_err": max(float((full[k] - rep[k]).abs().max()) for k in rep),
           "head_rows": tuple(tp_net.net.head.weight.shape)}

    mesh = mesh_mod.make_mesh(device=dev)
    cfg = dqn.DQNConfig(**PAR_CENSUS)
    ts = dqn.init_train_state(cfg, dqn.make_net(cfg, dev), gen)
    env = mesh_mod.shard_env_state(bc.reset_planes(cfg.num_envs, dev), mesh)
    buf = sharded_train.shard_buffer(replay.make_buffer(cfg.buffer_size, dev), mesh)
    it, _ = sharded_train.make_sharded_train_iteration(cfg, mesh)
    (env, buf, _), census = ca.collective_census(
        it, ts, env, buf, mesh_mod.rank_generator(0, rank, dev))
    param_bytes = sum(p.numel() * p.element_size() for p in ts.net.parameters())
    out.update({
        "census_ops": sorted({c["op"] for c in census}),
        "census_bytes": sum(c["bytes"] for c in census), "census_count": len(census),
        "param_bytes": param_bytes, "updates": cfg.update_per_collect,
        "env_partitioned": all(ca.is_partitioned(x.shape, (*x.shape[:-1], cfg.num_envs), world)
                               for x in env),
        "ring_partitioned": all(ca.is_partitioned(x.shape, (cfg.buffer_size, *x.shape[1:]), world)
                                for x in buf[:-2]),
    })
    return out


def timed_call(fn, *args, **kw):
    """(fn's result, its seconds on the host clock)."""
    w0 = time.perf_counter()
    return fn(*args, **kw), time.perf_counter() - w0


@contextlib.contextmanager
def zoo_dir(path: str):
    """``$GOBBLET_ZOO_DIR`` set to ``path`` for the block, restored after."""
    saved = os.environ.get("GOBBLET_ZOO_DIR")
    os.environ["GOBBLET_ZOO_DIR"] = path
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("GOBBLET_ZOO_DIR")
        else:
            os.environ["GOBBLET_ZOO_DIR"] = saved


def phase_tools(smi: str, gen: torch.Generator) -> None:
    """23. the repository's tools: make_zoo's command line in a process of
    its own, beside zoo writing, profile_dqn and exploitability here."""
    from gobblet_rl_torch import zoo
    from gobblet_rl_torch.ops import batched_core as bc
    from gobblet_rl_torch.scripts import exploitability, profile_dqn

    t0 = time.perf_counter()
    dev = gen.device
    committed = Path(zoo._zoo_dir())
    out = {"metric": "tools", "device": smi}
    with tempfile.TemporaryDirectory() as quick_zoo, \
            concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        # (b), started first: the quick pipeline as a user runs it, into a
        # temporary zoo; it trains on the card while (a), (c) and (d) run
        make_zoo_job = pool.submit(
            timed_call, subprocess.run,
            [sys.executable, "-m", "gobblet_rl_torch.scripts.make_zoo", "--quick",
             "--entries", "ppo_league", "--eval-games", "8", "--device", "cuda",
             "--zoo-dir", quick_zoo],
            cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
            timeout=TOOLS_MAKE_ZOO_TIMEOUT)

        # (a) each committed entry, loaded on the card, written back and
        # reloaded from what was written
        names = zoo.names()
        check(len(names) == 3, "tools: the committed zoo's three entries")
        with tempfile.TemporaryDirectory() as tmp:
            for name in names:
                entry = zoo.meta(name)
                net, _, _ = zoo.load(name, device=dev)
                with zoo_dir(tmp):
                    zoo.save(name, net, entry)
                    again, _, _ = zoo.load(name, device=dev)
                written = (Path(tmp) / entry["file"]).read_bytes()
                check(written == (committed / entry["file"]).read_bytes(),
                      f"tools: zoo.save of {name} from the card == the committed blob")
                check(all(torch.equal(v, again.state_dict()[k])
                          for k, v in net.state_dict().items()),
                      f"tools: {name} reloaded, every weight equal")
        out["zoo_entries_written"] = len(names)
        out["zoo_s"] = time.perf_counter() - t0

        # (c) the profile of the random-opponent DQN iteration at phase 5's
        # width (make_zoo's process shares the card meanwhile)
        with tempfile.TemporaryDirectory() as tmp:
            w0 = time.perf_counter()
            summary = profile_dqn.main(["--family", "dqn", "--envs", str(DQN["num_envs"]),
                                        "--iters", "3", "--top", "10", "--logdir", tmp])
            out["profile_s"] = time.perf_counter() - w0
            table = profile_dqn.device_op_table(next(Path(tmp).glob("trace-*.json")), dev)
        check(0 < summary["device_busy_frac_of_wall"] <= 1, "tools: busy share in (0, 1]")
        check(abs(sum(summary["by_class_ms"].values()) - summary["device_total_ms"]) < 1e-2,
              "tools: the classes sum to the device total")
        check(abs(3 * summary["module_ms_per_iter"] - summary["device_total_ms"]) < 1e-2,
              "tools: an iteration's device time is a third of the total")
        check(all(n >= 1 for _, _, n in table) and table, "tools: every row has a call")
        out["profile"] = {k: v for k, v in summary.items() if k != "top"}
        out["profile_rows"], out["profile_calls"] = len(table), sum(n for _, _, n in table)

        # (d) the exact-solver audit
        w0 = time.perf_counter()
        rows = exploitability.main(["--agents", "dqn_greedy", "random", "--games", "8",
                                    "--defense-games", "4", "--device", "cuda"])
        out["exploitability_s"] = time.perf_counter() - w0
        for r in rows:
            check(r["forced_loss_rate"] == 1.0,
                  f"tools: {r['agent']} loses by force as second player")
        out["exploitability"] = rows

        # (b)'s result: the manifest row, the blob, its policy on the card
        res, out["make_zoo_quick_s"] = make_zoo_job.result()
        print(res.stdout, end="", flush=True)
        check(res.returncode == 0, f"tools: make_zoo --quick exited {res.returncode}: "
                                   f"{res.stderr[-2000:]}")
        row = json.loads((Path(quick_zoo) / "manifest.json").read_text())["ppo_league"]
        check(row["family"] == "ppo" and "vs_random" in row["metrics"],
              "tools: make_zoo's manifest row")
        check((Path(quick_zoo) / "ppo_league.msgpack").stat().st_size > 1000,
              "tools: make_zoo's blob over 1,000 bytes")
        with zoo_dir(quick_zoo):
            pol = zoo.policy("ppo_league", device=dev)
        state = bc.reset_planes(64, dev)
        for _ in range(8):
            mask = bc.legal_mask_planes(state.board, state.current)
            actions = pol(gen, state.board, state.current)
            check(bool(mask[actions.long(), torch.arange(64, device=dev)].all()),
                  "tools: make_zoo's ppo_league plays legal moves on the card")
            state = bc.autoreset_planes(bc.step_planes(state, actions))
        out["make_zoo_metrics"] = row["metrics"]
    out["seconds"] = time.perf_counter() - t0
    log(json.dumps(out))


def start_timing_tools(pool) -> dict:
    """24, started: the port's bench and bench_scaling as command lines, each
    in a process of its own; {name: future of (completed process, seconds)}."""
    root = Path(__file__).resolve().parent
    jobs = {}
    for name, env in (("bench", BENCH_ENV), ("bench_scaling", {})):
        jobs[name] = pool.submit(
            timed_call, subprocess.run, [sys.executable, "-m", f"gobblet_rl_torch.scripts.{name}"],
            cwd=root, env={**os.environ, **env}, capture_output=True, text=True,
            timeout=BENCH_TIMEOUT)
    return jobs


def phase_timing_tools(smi: str, jobs: dict) -> dict:
    """24. the timing tools' results: their contracts on the card; returns
    the rollout kernel's launches in each."""
    t0 = time.perf_counter()
    out = {"metric": "timing_tools", "device": smi}
    runs = {}
    for name, job in jobs.items():
        res, seconds = job.result()
        print(res.stdout, end="", flush=True)
        check(res.returncode == 0, f"timing tools: {name} exited {res.returncode}: "
                                   f"{res.stderr[-2000:]}")
        runs[name] = ([json.loads(line) for line in res.stdout.strip().splitlines()],
                      res.stderr)
        out[f"{name}_s"] = seconds

    lines, err = runs["bench"]
    by_metric = {rec["metric"]: rec for rec in lines}
    check(lines[-1]["metric"] == "env_steps_per_sec" and lines[-1]["value"] > 0,
          "bench: the headline last, positive")
    for fam in ("dqn", "az", "ppo"):
        rec = by_metric.get(f"{fam}_train_env_steps_per_sec")
        check(rec is not None and rec["iterations_per_sec"] > 0, f"bench: the {fam} line")
        check(rec["mfu"] is not None and 0 <= rec["mfu"] <= 1, f"bench: {fam} mfu in [0, 1]")
        check(rec["flop_counter_flops_per_iter"] > 0, f"bench: {fam} FLOPs counted")
    aux = by_metric["rollout_roofline"]
    check(aux["hbm_util"] is not None and 0 < aux["hbm_util"] <= 1,
          "bench: the rollout's HBM share in (0, 1]")
    found = re.findall(r"# rollout kernel launches: (\d+)", err)
    check(len(found) == 1 and int(found[0]) == BENCH_KERNEL_LAUNCHES,
          "bench: the headline launched the rollout kernel once a call")
    launches = {"phase 24 bench": int(found[0])}
    out["bench"] = lines

    lines, err = runs["bench_scaling"]
    per_size = [rec for rec in lines if rec["metric"] == "weak_scaling_env_steps_per_sec"]
    check([rec["devices"] for rec in per_size] == [1] and per_size[0]["value"] > 0,
          "bench_scaling: size 1 on one card")
    check(lines[-1]["metric"] == "weak_scaling_efficiency" and lines[-1]["devices"] == 1,
          "bench_scaling: the summary at one device")
    found = re.findall(r"# 1 ranks: kernel launches \[(\d+)\]", err)
    check(found == [str(SCALING_KERNEL_LAUNCHES)], "bench_scaling: the rank launched the kernel")
    launches["phase 24 bench_scaling"] = int(found[0])
    out["bench_scaling"] = lines
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t0
    log(json.dumps(out))
    return launches


def phase_parallel(smi: str, gen: torch.Generator) -> None:
    """22. the parallel slice: world size 1, then two ranks on one card."""
    import torch.distributed as dist

    from gobblet_rl_torch.kernels import rollout as R
    from gobblet_rl_torch.parallel import mesh as mesh_mod
    from gobblet_rl_torch.parallel import sharded_alphazero, sharded_ppo, sharded_train
    from gobblet_rl_torch.parallel.multihost import launch_local, spawn_ranks
    from gobblet_rl_torch.train import alphazero as az
    from gobblet_rl_torch.train import dqn, ppo, replay

    t0 = time.perf_counter()
    dev = gen.device
    out = {}
    R.rollout_random_fused.launches = 0
    # the CPU side of the PPO check runs on a gloo rank beside the card work;
    # one thread a job, so no job waits for another's
    case = small_ppo_case()
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=5)
    cpu_job = pool.submit(spawn_ranks, cpu_ppo_rank, 1, (case,), device="cpu", backend="gloo",
                          timeout=300)
    with tempfile.TemporaryDirectory() as tmp:
        mesh_mod.init_distributed(f"file://{tmp}/store", 1, 0, backend=PAR_BACKEND, device=dev)
        try:
            mesh = mesh_mod.make_mesh(device=dev)
            # DQN at phase 5's width: sharded and unsharded from one seed
            config = dqn.DQNConfig(**DQN)
            runs = {}
            for name, make in (("sharded", lambda: sharded_train.make_sharded_train_iteration(
                    config, mesh)), ("unsharded", lambda: dqn.make_train_iteration(config))):
                g = torch.Generator(device=dev)
                g.manual_seed(11)
                ts = dqn.init_train_state(config, dqn.make_net(config, dev), g)
                it, opp = make()
                env = dqn.init_env_state(config, opp, ts.opponent_net, g)
                buf = replay.make_buffer(config.buffer_size, dev)
                ms = []
                for _ in range(2):
                    torch.cuda.synchronize()
                    w0 = time.perf_counter()
                    env, buf, loss = it(ts, env, buf, g)
                    loss = float(loss)   # synchronises
                    ms.append(1e3 * (time.perf_counter() - w0))
                runs[name] = (ts, env, buf, ms, loss)
            (ts_a, env_a, buf_a, ms_a, loss_a), (ts_b, env_b, buf_b, ms_b, loss_b) = (
                runs["sharded"], runs["unsharded"])
            check(nets_equal(ts_a.net, ts_b.net) and nets_equal(ts_a.target_net, ts_b.target_net),
                  "parallel: world-1 DQN params == unsharded")
            check(trees_equal(buf_a, buf_b), "parallel: world-1 DQN ring == unsharded")
            check(trees_equal(env_a, env_b), "parallel: world-1 DQN env state == unsharded")
            check(loss_a == loss_b and math.isfinite(loss_a), "parallel: world-1 DQN loss")
            sync = mesh_mod.GradSync(mesh.get_group(mesh_mod.ENV_AXIS))
            _, sync_ms = timed(lambda: sync(ts_a.net.parameters(), torch.zeros((), device=dev)),
                               PAR_SYNC_REPEATS)
            out["dqn_world1"] = {"sharded_iteration_ms": ms_a, "unsharded_iteration_ms": ms_b,
                                 "sync_ms_per_update": statistics.median(sync_ms),
                                 "sync_bytes": 4 * (1 + sum(p.numel() for p in
                                                            ts_a.net.parameters())),
                                 "loss": loss_a}
            del runs, ts_a, ts_b, env_a, env_b, buf_a, buf_b
            log(f"# phase 22: {json.dumps(out['dqn_world1'])}")

            # PPO at phase 15's width, timed
            cfg = ppo.PPOConfig(**PPO)
            st = ppo.init_ppo(cfg, gen)
            net, opt = st.nets[0], st.optimizers[0]
            before = {k: v.clone() for k, v in net.state_dict().items()}
            it = sharded_ppo.make_sharded_ppo_iteration(cfg, mesh, dev)
            env, ppo_ms = st.env_states[0], []
            for _ in range(3):
                torch.cuda.synchronize()
                w0 = time.perf_counter()
                env, stats = it(net, net, opt, env, gen, cfg.learner_player)
                ppo_loss = float(stats["loss"])
                ppo_ms.append(1e3 * (time.perf_counter() - w0))
                check(math.isfinite(ppo_loss) and int(stats["episodes"]) > 0,
                      "parallel: world-1 PPO loss finite, episodes")
            check(any(not torch.equal(before[k], v) for k, v in net.state_dict().items()),
                  "parallel: world-1 PPO params changed")
            out["ppo_world1"] = {"iteration_ms": ppo_ms, "first_is_warm_up": True,
                                 "loss": ppo_loss}
            del st, net, opt, env

            # PPO card against CPU on exact linear nets under one set of draws
            card = run_small_ppo(case, dev)

            out["world1_before_az_s"] = time.perf_counter() - t0
            # two gloo ranks on the one card: the three families' launches and
            # the TP + census ranks run at once, beside the AZ check below, so
            # their seconds overlap
            dqn_config = {k: v for k, v in DQN.items() if k != "num_envs"}
            family_kw = {"dqn": dict(num_envs=DQN["num_envs"], iterations=2, config=dqn_config),
                         "az": dict(num_envs=PAR_SMALL["az"], iterations=1),
                         "ppo": dict(num_envs=PAR_SMALL["ppo"], iterations=1)}
            jobs = {family: pool.submit(timed_call, launch_local, 1, 2, family=family,
                                        device=str(dev), backend=PAR_RANK_BACKEND, timeout=300,
                                        **kw)
                    for family, kw in family_kw.items()}
            tp_job = pool.submit(timed_call, spawn_ranks, tp_census_rank, 2, (PAR_TP_B,),
                                 device=str(dev), backend=PAR_RANK_BACKEND, timeout=300)

            # AZ at the resume checks' cut, bit for bit; cuDNN's deterministic
            # algorithms, so two runs of one conv backward agree
            deterministic = torch.backends.cudnn.deterministic
            torch.backends.cudnn.deterministic = True
            try:
                cfg = az.AZConfig(**PAR_AZ)
                states, az_s = [], []
                for sharded in (True, False):
                    g = torch.Generator(device=dev)
                    g.manual_seed(12)
                    st = az.init_alphazero(cfg, g)
                    it = (sharded_alphazero.make_sharded_az_iteration(cfg, mesh) if sharded
                          else az.make_train_iteration(cfg))
                    w0 = time.perf_counter()
                    stats = it(st, g)
                    az_loss = float(stats["loss"])
                    az_s.append(time.perf_counter() - w0)
                    states.append((st, az_loss))
            finally:
                torch.backends.cudnn.deterministic = deterministic
            (st_a, l_a), (st_b, l_b) = states
            check(nets_equal(st_a.net, st_b.net) and trees_equal(st_a.env_state, st_b.env_state),
                  "parallel: world-1 AZ params and env state == unsharded")
            check(l_a == l_b and math.isfinite(l_a), "parallel: world-1 AZ loss")
            out["az_world1"] = {"sharded_s": az_s[0], "unsharded_s": az_s[1], "loss": l_a,
                                "beside_the_launches": True}
            log(f"# phase 22: {json.dumps(out['az_world1'])}")
            del states, st_a, st_b
        finally:
            dist.destroy_process_group()
    (cpu,) = cpu_job.result()
    err = max(float((card[k] - cpu[k]).abs().max()) for k in card)
    check(err <= PAR_TOL, f"parallel: PPO card == CPU within {PAR_TOL} (max {err:.3g})")
    out["ppo_card_vs_cpu_max_abs_err"] = err
    launches = {}
    for family, job in jobs.items():
        res, secs = job.result()   # launch_local raises unless one digest
        check(len(res) == 2 and all(math.isfinite(r["loss"]) for r in res),
              f"parallel: two-rank {family} finite loss on both ranks")
        launches[family] = {"launch_s": secs, "iterations_s": [r["seconds"] for r in res],
                            "loss": res[0]["loss"], "digest": res[0]["digest"][:16],
                            **({"grad_steps": res[0]["grad_steps"]} if family == "dqn" else {})}
    check(launches["dqn"]["grad_steps"] == 2 * DQN["update_per_collect"],
          "parallel: two-rank DQN grad steps")
    out["two_ranks"] = launches

    ranks, tp_s = tp_job.result()
    pool.shutdown()
    for r in ranks:
        check(r["tp_forward_err"] <= PAR_TOL and r["tp_step_loss_err"] <= PAR_TOL
              and r["tp_step_param_err"] <= PAR_TOL,
              f"parallel: TP forward and step == replicated within {PAR_TOL}")
        check(r["census_ops"] == ["all_reduce"], "parallel: the DP census holds only all-reduces")
        check(r["census_bytes"] <= r["updates"] * (r["param_bytes"] + 4096),
              "parallel: the DP census within updates x (param bytes + 4096)")
        check(r["env_partitioned"] and r["ring_partitioned"], "parallel: env and ring blocks")
    out["tp_census"] = {**ranks[0], "launch_s": tp_s}
    check(R.rollout_random_fused.launches == 0, "parallel: the path launches no rollout kernel")
    log(json.dumps({"metric": "parallel", "device": smi, **out,
                    "seconds": time.perf_counter() - t0}))


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
    run_t0 = time.perf_counter()
    smi = smi_query("name,power.limit")
    sm_mhz = float(smi_query("clocks.max.sm").split()[0])
    kind = torch.cuda.get_device_name(0)
    log(smi)
    log(f"# device {kind}; python {sys.version.split()[0]}; torch {torch.__version__}; "
        f"cuda {torch.version.cuda}; SM clock max {sm_mhz:.0f} MHz")

    # 2. build, registers, occupancy and the ply loop's instructions --------
    t0 = time.perf_counter()
    lib, nvcc_log = build.build("rollout")
    log(f"# build: rollout in {time.perf_counter() - t0:.2f}s -> {lib.name}")
    for line in nvcc_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"#   {line.strip()}")
    check(all(n == "0" for n in re.findall(r"(\d+) bytes spill", nvcc_log)),
          "ptxas reports no spills")
    occupancy = build.load("rollout").gobblet_rollout_blocks_per_sm
    occupancy.argtypes, occupancy.restype = [ctypes.c_int], ctypes.c_int
    per_sm = [occupancy(mode) for mode in (0, 1)]
    blocks = -(-ROLLOUT_B // 256)
    log(f"# blocks per SM (philox, field): {per_sm}; {blocks} blocks of 256 at B={ROLLOUT_B} "
        f"= {blocks / (SMS * per_sm[0]):.2f} waves over {SMS} SMs")
    counts = sass_counts(lib)
    if counts is not None:
        sass, sass_alu, opcodes = counts
        log(f"# sass: {sass} instructions per env-ply in the philox ply loop, {sass_alu} on "
            f"the integer ALU pipe; {json.dumps(opcodes)}")
    else:
        log(f"# sass: not measured (no cuobjdump beside nvcc); bound from the source count "
            f"{sum(OPS_PER_PLY.values())} per env-ply at the issue rate")

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    # 3. kernel vs plain version, small batch -------------------------------
    field = torch.randint(-2**31, 2**31, (CHECK_STEPS, 54, CHECK_B), dtype=torch.int32,
                          device=dev, generator=gen).view(torch.uint32)
    # mid-game states after 5 plies, and deep ones after 40 whose boards carry
    # covered and frozen pieces; the ragged batch leaves the last block of
    # 256 threads partly empty
    for start_plies in (5, 40):
        start, _ = bc.rollout_random(bc.reset_planes(CHECK_B, dev), gen, start_plies)
        board, cur = start.board.contiguous(), start.current.contiguous()
        covered = int(((board[0] != 0) & (board[1] != 0)).sum())
        for mode, n, draws, seed in (("field", CHECK_B, field, 0), ("philox", CHECK_B, None, 7),
                                     ("philox", RAGGED_B, None, 3)):
            b, c = board[..., :n].contiguous(), cur[:n].contiguous()
            kb, kc, ks = R.rollout_random_fused(b, c, CHECK_STEPS, seed=seed, draws=draws)
            ref = draws if draws is not None else R.philox_field(seed, CHECK_STEPS, n, dev)
            pb, pc, ps = R.rollout_random_fused_plain(b, c, CHECK_STEPS, ref)
            torch.cuda.synchronize()
            what = f"{mode} from {start_plies} plies, B={n}"
            check(torch.equal(kb, pb) and torch.equal(kc, pc), f"{what}: kernel state == plain")
            for k in ks:
                check(int(ks[k]) == int(ps[k]), f"{what}: kernel {k} == plain")
            log(f"# check {what}, plies={CHECK_STEPS}: bit-identical (tolerance 0), "
                f"episodes={int(ks['episodes'])}, covered small pieces at start={covered}")
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
    env_plies = ROLLOUT_B * ROLLOUT_STEPS
    if counts is not None:
        ops_ms = issue_floor_ms(sass, sass_alu, env_plies, sm_mhz)
    else:  # the source count, all of it at the issue rate
        ops_ms = issue_floor_ms(sum(OPS_PER_PLY.values()), 0, env_plies, sm_mhz)
    bytes_ms = 1e3 * nbytes / PEAK_HBM_BYTES
    log(f"# phases 1-6: {time.perf_counter() - run_t0:.1f} s")

    # 7-11. the modules of the DQN family beyond the main path --------------
    phase_greedy(smi, gen)
    phase_greedy_dqn(smi, gen)
    phase_cli_resume(smi)
    phase_vector(smi, gen)
    phase_zoo(smi, gen)

    # 12-14. the AlphaZero family; its path launches no kernel -------------
    phase_search(smi, gen)
    phase_alphazero(smi, gen)
    phase_az_zoo(smi, gen)

    # 15-17. the PPO family, the defense bank and the audit; no kernel ------
    phase_ppo(smi, gen)
    phase_ppo_league(smi, gen)
    phase_ppo_zoo(smi, gen)

    # 18-20. evaluation and the per-env API; no kernel ----------------------
    phase_value_search(smi, gen)
    phase_tournament(smi, gen)
    phase_env_api(smi, gen)

    # 21. the host surface's agents; no kernel ------------------------------
    phase_host_agents(smi, gen)

    # 22. the parallel slice; no kernel --------------------------------------
    phase_parallel(smi, gen)

    # 23-24. the repository's tools; phase 24's timing tools, started first,
    # run beside phase 23 in processes of their own and launch the kernel --
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
        timing_jobs = start_timing_tools(pool)
        phase_tools(smi, gen)
        path_launches = {"phases 4-5": launches, **phase_timing_tools(smi, timing_jobs)}

    log(f"# all phases: {time.perf_counter() - run_t0:.1f} s")
    log(f"# bound: bytes {bytes_ms:.4f} ms; operations {ops_ms:.4f} ms; kernel at "
        f"{ops_ms / statistics.median(kernel_ms):.1%} of the larger")
    log(smi)
    log(json.dumps({"kernels": [{
        "name": "rollout_random_fused",
        "route": "cuda",
        "source": "gobblet_rl_torch/kernels/csrc/rollout.cu",
        "replaces": "gobblet_rl_tpu/ops/pallas_rollout.py:176",
        "launches": sum(path_launches.values()),
        "launches_by_path": path_launches,
        "max_abs_err": err,
        "ms": statistics.median(kernel_ms),
        "plain_ms": min(plain_ms),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
        "library_ms": None,
        "sass_per_env_ply": sass if counts is not None else "not measured",
    }]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
