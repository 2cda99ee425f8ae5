"""Multi-process training: one OS process per rank over ``torch.distributed``.

Port of ``gobblet_rl_tpu/parallel/multihost.py``.  JAX runs one process per
host over a global mesh of all hosts' devices; here every device is a rank
of its own process, and a "process" in JAX's sense (a host) holds
``LOCAL_WORLD_SIZE`` of them.  The same data-parallel iterations of
``parallel/sharded_*.py`` run unchanged across processes: the gradient
``all_reduce`` crosses the process boundary (gloo on the CPU, NCCL between
cards).

``run_worker`` below is one rank's whole life: join the process group,
build the replicated train state and this rank's block of the env batch,
run N iterations, and report a digest of the parameters that the launcher
compares across ranks (identical digests prove the gradient sync spanned
them).  It runs under

* ``python -m gobblet_rl_torch.parallel.multihost --process-id I ...``
  (JAX's flags, plus ``--device``, ``--backend`` and ``--config``), and
* :func:`launch_local`, which spawns every rank on this host with the
  torchrun-style ``RANK``/``LOCAL_RANK``/``WORLD_SIZE`` environment.

:func:`spawn_ranks` runs any importable function on N spawned ranks of a
fresh process group (the tests' and ``chip_smoke.py``'s helper).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import multiprocessing
import os
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch


def pick_free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _params_digest(net: torch.nn.Module) -> str:
    """Order-stable sha256 over the ``state_dict`` tensors in key order, as
    contiguous CPU bytes."""
    h = hashlib.sha256()
    for x in net.state_dict().values():
        h.update(np.ascontiguousarray(x.detach().cpu().numpy()).tobytes())
    return h.hexdigest()


def _family_run(family: str, num_envs: int, iterations: int, config: dict, mesh, rank: int,
                dev: torch.device):
    """(learner net, last loss, extra result keys) of ``iterations``
    iterations of ``family`` with JAX's tiny configuration of that family
    (``config`` replaces fields).  The replicated state is built from one
    seed on every rank; each rank draws from its own generator."""
    from gobblet_rl_torch.ops import batched_core as bc
    from gobblet_rl_torch.parallel import mesh as mesh_mod

    init = torch.Generator(device=dev)
    init.manual_seed(0)
    generator = mesh_mod.rank_generator(0, rank, dev)
    if family == "dqn":
        from gobblet_rl_torch.parallel import sharded_train
        from gobblet_rl_torch.train import dqn, replay

        cfg = dqn.DQNConfig(**{
            **dict(num_envs=num_envs, buffer_size=max(256, 8 * num_envs), batch_size=num_envs,
                   segment_len=4, update_per_collect=2, opponent="random"),
            **config})
        ts = dqn.init_train_state(cfg, dqn.make_net(cfg, dev), init)
        env_state = mesh_mod.shard_env_state(bc.reset_planes(cfg.num_envs, dev), mesh)
        buffer = sharded_train.shard_buffer(replay.make_buffer(cfg.buffer_size, dev), mesh)
        it, _ = sharded_train.make_sharded_train_iteration(cfg, mesh)
        for _ in range(iterations):
            env_state, buffer, loss = it(ts, env_state, buffer, generator)
        return ts.net, loss, {"grad_steps": ts.grad_steps}
    if family == "az":
        from gobblet_rl_torch.parallel import sharded_alphazero
        from gobblet_rl_torch.train import alphazero as az

        cfg = az.AZConfig(**{
            **dict(num_envs=num_envs, num_sims=4, segment_len=4, temp_moves=2,
                   batch_size=num_envs, updates_per_iter=1, model="mlp", hidden_sizes=(16,)),
            **config})
        st = az.init_alphazero(cfg, init)
        st.env_state = mesh_mod.shard_env_state(st.env_state, mesh)
        it = sharded_alphazero.make_sharded_az_iteration(cfg, mesh)
        for _ in range(iterations):
            loss = it(st, generator)["loss"]
        return st.net, loss, {}
    if family == "ppo":
        from gobblet_rl_torch.parallel import sharded_ppo
        from gobblet_rl_torch.train import ppo as ppo_mod

        cfg = ppo_mod.PPOConfig(**{
            **dict(num_envs=num_envs, segment_len=4, minibatches=2, epochs_per_iter=1,
                   hidden_sizes=(16,), model="mlp"),
            **config})
        st = ppo_mod.init_ppo(cfg, init)
        env_state = mesh_mod.shard_env_state(st.env_states[0], mesh)
        it = sharded_ppo.make_sharded_ppo_iteration(cfg, mesh, dev)
        for _ in range(iterations):
            env_state, stats = it(st.nets[0], st.nets[1], st.optimizers[0], env_state,
                                  generator, 0)
        return st.nets[0], stats["loss"], {}
    raise ValueError(f"unknown family {family!r}")


def run_worker(
    coordinator: str,
    num_processes: int,
    process_id: int,
    *,
    iterations: int = 2,
    num_envs: int = 32,
    family: str = "dqn",
    device=None,
    backend=None,
    config: dict | None = None,
    emit=print,
) -> dict:
    """One rank of a multi-process training run (``family``: dqn | az |
    ppo).  The rank is device ``LOCAL_RANK`` of process ``process_id`` of
    ``num_processes``, each with ``LOCAL_WORLD_SIZE`` devices (1 if
    unset); ``device=None`` means the CUDA card.  Returns, and emits as one
    JSON line, ``{"process_id", "rank", "processes", "devices", "family",
    "loss", "digest", "seconds", ...}`` (``grad_steps`` for DQN;
    ``seconds``: the iterations', after the setup)."""
    import torch.distributed as dist

    from gobblet_rl_torch.parallel import mesh as mesh_mod

    torch.set_num_threads(1)   # the ranks of one host share its cores
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    rank = process_id * local_world + int(os.environ.get("LOCAL_RANK", 0))
    world = num_processes * local_world
    dev = mesh_mod.init_distributed(coordinator, world, rank, backend=backend, device=device)
    try:
        mesh = mesh_mod.make_mesh(device=dev)
        t0 = time.perf_counter()
        net, loss, extra = _family_run(family, num_envs, iterations, config or {}, mesh,
                                       rank, dev)
        loss = float(loss)   # synchronises
        seconds = time.perf_counter() - t0
        result = {
            "process_id": process_id,
            "rank": rank,
            "processes": num_processes,
            "devices": dist.get_world_size(),
            "family": family,
            "loss": loss,
            "digest": _params_digest(net),
            "seconds": seconds,
            **extra,
        }
    finally:
        dist.destroy_process_group()
    emit(json.dumps(result), flush=True)
    return result


def _repo_root() -> str:
    return str(Path(__file__).resolve().parents[2])


def launch_local(
    num_processes: int = 2,
    devices_per_process: int = 2,
    *,
    iterations: int = 2,
    num_envs: int = 32,
    family: str = "dqn",
    timeout: float = 300.0,
    device=None,
    backend=None,
    config: dict | None = None,
) -> list[dict]:
    """Spawn ``num_processes x devices_per_process`` ranks on localhost, one
    OS process each, wait for all, and return their result dicts sorted by
    rank (``processes == num_processes``, ``devices`` the world size).
    ``device=None`` means the CUDA card (every rank binds to card
    ``LOCAL_RANK`` modulo the card count; NCCL needs one card a rank).

    Raises if any worker fails or the parameter digests disagree: equal
    digests prove that the gradient sync spanned the ranks."""
    world = num_processes * devices_per_process
    port = pick_free_port()
    env = {**os.environ, "WORLD_SIZE": str(world), "LOCAL_WORLD_SIZE": str(devices_per_process),
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}
    env["PYTHONPATH"] = _repo_root() + os.pathsep + env.get("PYTHONPATH", "")
    flags = ["--iterations", str(iterations), "--num-envs", str(num_envs), "--family", family]
    if device is not None:
        flags += ["--device", str(device)]
    if backend is not None:
        flags += ["--backend", backend]
    if config:
        flags += ["--config", json.dumps(config)]
    results, errors = [], []
    # each rank writes to files, not pipes: a rank blocked on a full pipe
    # would stall the collectives of the others
    with tempfile.TemporaryDirectory() as tmp:
        logs = [(Path(tmp) / f"rank{r}.out", Path(tmp) / f"rank{r}.err") for r in range(world)]
        procs = []
        try:
            for rank in range(world):
                process_id, local_rank = divmod(rank, devices_per_process)
                with open(logs[rank][0], "w") as out, open(logs[rank][1], "w") as err:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", "gobblet_rl_torch.parallel.multihost",
                         "--coordinator", f"localhost:{port}",
                         "--num-processes", str(num_processes),
                         "--process-id", str(process_id), *flags],
                        env={**env, "RANK": str(rank), "LOCAL_RANK": str(local_rank)},
                        stdout=out, stderr=err))
            deadline = time.monotonic() + timeout
            while any(p.poll() is None for p in procs):   # a failed rank stops the rest
                if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for rank, (p, (out, err)) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                errors.append(f"rank {rank} rc={p.returncode}\n{err.read_text()[-2000:]}")
            else:
                results.append(json.loads(out.read_text().strip().splitlines()[-1]))
    if errors:
        raise RuntimeError("multihost workers failed:\n" + "\n---\n".join(errors))
    results.sort(key=lambda r: r["rank"])
    if len({r["digest"] for r in results}) != 1:
        raise RuntimeError(f"param digests diverged across ranks: {results}")
    return results


def _spawned_rank(rank, world, init_method, backend, device, fn, args, out):
    """Entry of one spawned rank: join the group, run ``fn``, save its
    result to ``out`` (a traceback on failure), leave the group."""
    import torch.distributed as dist

    from gobblet_rl_torch.parallel import mesh as mesh_mod

    torch.set_num_threads(1)
    os.environ["LOCAL_RANK"] = str(rank)
    try:
        dev = mesh_mod.init_distributed(init_method, world, rank, backend=backend, device=device)
        try:
            result = fn(rank, world, dev, *args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        Path(out).write_text(traceback.format_exc())
        raise
    torch.save(result, out + ".pt")


def spawn_ranks(fn, world_size: int, args: tuple = (), *, device=None, backend=None,
                timeout: float = 300.0) -> list:
    """Run ``fn(rank, world_size, device, *args)`` on ``world_size`` spawned
    processes joined in a fresh process group (a ``file://`` store in a
    temporary directory, so concurrent calls never collide; one intra-op
    thread a rank) and return each rank's result, by rank.  ``fn`` must be
    importable (a module's top-level function); results travel through
    ``torch.save``.  ``device=None`` means the CUDA card.  Raises, and
    stops every rank, if one fails or the time runs out."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init_method = f"file://{tmp}/store"
        outs = [os.path.join(tmp, f"rank{r}") for r in range(world_size)]
        procs = [ctx.Process(target=_spawned_rank,
                             args=(r, world_size, init_method, backend,
                                   None if device is None else str(device), fn, args, outs[r]))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs) or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            logs = [Path(outs[r]).read_text() for r in failed if os.path.exists(outs[r])]
            raise RuntimeError(f"ranks {failed} of {world_size} failed or timed out:\n"
                               + "\n---\n".join(logs))
        return [torch.load(o + ".pt", weights_only=False) for o in outs]


def _main() -> None:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--coordinator", required=True,
                        help="host:port of the rank-0 store, or a file:// path")
    parser.add_argument("--num-processes", type=int, required=True)
    parser.add_argument("--process-id", type=int, required=True)
    parser.add_argument("--iterations", type=int, default=2)
    parser.add_argument("--num-envs", type=int, default=32)
    parser.add_argument("--family", type=str, default="dqn", choices=["dqn", "az", "ppo"])
    parser.add_argument("--device", default=None, help="default: the CUDA card")
    parser.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                        help="default: nccl on the card, gloo on the CPU")
    parser.add_argument("--config", type=json.loads, default=None,
                        help="JSON object of config fields replacing the family's")
    args = parser.parse_args()
    run_worker(
        args.coordinator,
        args.num_processes,
        args.process_id,
        iterations=args.iterations,
        num_envs=args.num_envs,
        family=args.family,
        device=args.device,
        backend=args.backend,
        config=args.config,
    )


if __name__ == "__main__":
    _main()
