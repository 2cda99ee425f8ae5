#!/bin/bash
# Train-loop batch-size sweep of the port on the card: runs each section
# of the port's bench (python -m gobblet_rl_torch.scripts.bench, with
# GOBBLET_BENCH_ONLY) across env counts to find the throughput-optimal
# configuration.  The grid and the JSONL prefixing of scripts/
# sweep_train_envs.sh.  Serial by design: one process on the card at a
# time, each section holding its memory.
# Usage: gobblet_rl_torch/scripts/sweep_train_envs.sh [out.jsonl [sections]]
# where sections is a comma-separated subset of dqn,ppo,az (default: all).
set -u
OUT=${1:-${TMPDIR:-/tmp}/sweep_train.jsonl}
SECTIONS=,${2:-dqn,ppo,az},
REPO=$(cd "$(dirname "$0")/../.." && pwd)
: > "$OUT"

run() {  # run <section> <extra env as K=V...>
  local section=$1; shift
  [[ $SECTIONS == *,$section,* ]] || return 0
  echo "### $section $*" >&2
  env "$@" GOBBLET_BENCH_ONLY="$section" PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}" \
    timeout 1800 python -m gobblet_rl_torch.scripts.bench \
    2>>"${OUT%.jsonl}.log" | while read -r line; do
      # the bench prints one JSON object per line; anything else (a crash
      # traceback fragment, a stray print) must not silently corrupt OUT
      if [[ $line == {* ]]; then
        echo "{\"config\": \"$*\", ${line#\{}"
      else
        echo "WARN: non-JSON bench output dropped: $line" >&2
      fi
    done >> "$OUT"
  local status=${PIPESTATUS[0]}
  if [[ $status -ne 0 ]]; then
    echo "WARN: section '$section $*' exited $status (see ${OUT%.jsonl}.log)" >&2
    echo "{\"config\": \"$*\", \"metric\": \"${section}_FAILED\", \"exit\": $status}" >> "$OUT"
  fi
}

run dqn GOBBLET_BENCH_TRAIN_ENVS=16384
run dqn GOBBLET_BENCH_TRAIN_ENVS=32768
run dqn GOBBLET_BENCH_TRAIN_ENVS=65536
run dqn GOBBLET_BENCH_TRAIN_ENVS=131072

run ppo GOBBLET_BENCH_PPO_ENVS=2048
run ppo GOBBLET_BENCH_PPO_ENVS=4096
run ppo GOBBLET_BENCH_PPO_ENVS=8192
run ppo GOBBLET_BENCH_PPO_ENVS=16384

# the AZ legs run the default search, gumbel_lm (set
# GOBBLET_BENCH_AZ_SEARCH=gumbel to sweep the batch-first tree)
run az GOBBLET_BENCH_AZ_ENVS=512
run az GOBBLET_BENCH_AZ_ENVS=1024
run az GOBBLET_BENCH_AZ_ENVS=2048
run az GOBBLET_BENCH_AZ_ENVS=4096
run az GOBBLET_BENCH_AZ_ENVS=8192

cat "$OUT"
