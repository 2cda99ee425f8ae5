"""Rank bodies of the parallel tests of the torch port.

``gobblet_rl_torch.parallel.multihost.spawn_ranks`` runs each function
here on N spawned processes joined in a gloo process group, as
``fn(rank, world, device, *args)``.  This module imports torch, numpy and
the port only, never JAX, so a rank starts fast and proves that the port
runs without it; the tests trade arrays with the ranks as numpy arrays.
"""

import copy
import dataclasses
import sys

import torch

from gobblet_rl_torch.models import actor_critic as tac
from gobblet_rl_torch.models import mlp as tmlp
from gobblet_rl_torch.ops import batched_core as tbc
from gobblet_rl_torch.parallel import collective_audit as ca
from gobblet_rl_torch.parallel import mesh as mesh_mod
from gobblet_rl_torch.parallel import sharded_alphazero, sharded_ppo, sharded_train
from gobblet_rl_torch.parallel import tensor_parallel as tp
from gobblet_rl_torch.train import alphazero as taz
from gobblet_rl_torch.train import dqn as tdqn
from gobblet_rl_torch.train import ppo as tppo
from gobblet_rl_torch.train import replay as trp

JAX_MODULES = ("jax", "jaxlib", "flax", "optax", "gobblet_rl_tpu")


def to_np(tree):
    """numpy copies of the tensors of a dict, tuple or named tuple."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_np(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(to_np(x) for x in tree)) if hasattr(tree, "_fields") else tuple(
            to_np(x) for x in tree)
    return tree


def planes(arrays, dev):
    return tbc.PlanesState(*(torch.from_numpy(x).to(dev) for x in arrays))


def no_jax() -> bool:
    return not [m for m in sys.modules if m.split(".")[0] in JAX_MODULES]


# ---------------------------------------------------------------------------
# mesh
# ---------------------------------------------------------------------------
def mesh_rank(rank, world, dev, state_np):
    """The mesh's shape and names, its refusals, and this rank's block of a
    global env state."""
    mesh = mesh_mod.make_mesh(device=dev)
    out = {"shape": tuple(mesh.shape), "names": mesh.mesh_dim_names, "no_jax": no_jax(),
           "block": to_np(mesh_mod.shard_env_state(planes(state_np, dev), mesh))}
    if world % 2 == 0:
        mesh2 = mesh_mod.make_mesh(model_parallel=2, device=dev)
        out["shape_mp2"] = tuple(mesh2.shape)
        out["env_index_mp2"] = mesh_mod.axis_index(mesh2, mesh_mod.ENV_AXIS)
    for bad in (dict(model_parallel=3), dict(num_devices=world + 1)):
        try:
            mesh_mod.make_mesh(device=dev, **bad)
        except (AssertionError, ValueError) as e:
            out.setdefault("refused", []).append(type(e).__name__)
    return out


# ---------------------------------------------------------------------------
# DQN
# ---------------------------------------------------------------------------
def f32_qnet(state, hidden, dev, dtype=torch.float32):
    """The dueling ``QNet`` over float32 params ``state``, computing in
    ``dtype``."""
    net = tmlp.QNet(hidden_sizes=hidden, dueling=True, dtype=dtype, device=dev)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return net


def dqn_update_rank(rank, world, dev, params, target, batch, hidden, cfg_kw):
    """One synced update on this rank's block of ``batch``, the nets
    computing in float64 (Adam divides each gradient by its own RMS, so a
    float32 sum in another order moves a near-zero gradient's step by a
    visible fraction of the lr)."""
    mesh = mesh_mod.make_mesh(device=dev)
    cfg = tdqn.DQNConfig(**cfg_kw)
    net = f32_qnet(params, hidden, dev, torch.float64)
    ts = tdqn.TrainState(net=net, target_net=f32_qnet(target, hidden, dev, torch.float64),
                         opponent_net=f32_qnet(params, hidden, dev, torch.float64),
                         optimizer=torch.optim.Adam(net.parameters(), lr=cfg.lr,
                                                    betas=(0.9, 0.999), eps=1e-8))
    local = tp.shard_batch_dp(tuple(torch.from_numpy(x) for x in batch), mesh)
    sync = mesh_mod.GradSync(mesh.get_group(mesh_mod.ENV_AXIS))
    loss = tdqn.update(cfg, ts, local, grad_sync=sync)
    return {"loss": float(loss), "params": to_np(net.state_dict()), "grad_steps": ts.grad_steps}


def dqn_iterations_rank(rank, world, dev, cfg_kw, iterations):
    """``iterations`` sharded DQN iterations from the seed-0 train state."""
    from gobblet_rl_torch.parallel.multihost import _params_digest

    mesh = mesh_mod.make_mesh(device=dev)
    cfg = tdqn.DQNConfig(**cfg_kw)
    ts = tdqn.init_train_state(cfg, tdqn.make_net(cfg, dev), torch.Generator().manual_seed(0))
    env_state = mesh_mod.shard_env_state(tbc.reset_planes(cfg.num_envs, dev), mesh)
    buffer = sharded_train.shard_buffer(trp.make_buffer(cfg.buffer_size, dev), mesh)
    it, _ = sharded_train.make_sharded_train_iteration(cfg, mesh)
    gen = mesh_mod.rank_generator(0, rank, dev)
    losses = []
    for _ in range(iterations):
        env_state, buffer, loss = it(ts, env_state, buffer, gen)
        losses.append(float(loss))
    return {"losses": losses, "grad_steps": ts.grad_steps, "filled": buffer.filled,
            "cursor": buffer.cursor, "digest": _params_digest(ts.net),
            "rows": buffer.board.shape[0], "envs": env_state.current.shape[0],
            "actions": to_np(buffer.action)}


def dqn_world1_rank(rank, world, dev, cfg_kw, iterations):
    """World size 1: the sharded iteration and the unsharded one from the
    same seed, side by side; whether params, ring, env state and losses
    are equal bit for bit."""
    mesh = mesh_mod.make_mesh(device=dev)
    cfg = tdqn.DQNConfig(**cfg_kw)
    runs = []
    for make in (lambda: sharded_train.make_sharded_train_iteration(cfg, mesh),
                 lambda: tdqn.make_train_iteration(cfg)):
        gen = torch.Generator().manual_seed(5)
        ts = tdqn.init_train_state(cfg, tdqn.make_net(cfg, dev), gen)
        it, opp = make()
        env_state = tdqn.init_env_state(cfg, opp, ts.opponent_net, gen)
        buffer = trp.make_buffer(cfg.buffer_size, dev)
        losses = []
        for _ in range(iterations):
            env_state, buffer, loss = it(ts, env_state, buffer, gen)
            losses.append(loss)
        runs.append((ts, env_state, buffer, torch.stack(losses)))
    (ts_a, env_a, buf_a, loss_a), (ts_b, env_b, buf_b, loss_b) = runs
    return {
        "params": all(torch.equal(x, y) for x, y in zip(ts_a.net.state_dict().values(),
                                                       ts_b.net.state_dict().values())),
        "target": all(torch.equal(x, y) for x, y in zip(ts_a.target_net.state_dict().values(),
                                                       ts_b.target_net.state_dict().values())),
        "ring": all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
                    for x, y in zip(buf_a, buf_b)),
        "env": all(torch.equal(x, y) for x, y in zip(env_a, env_b)),
        "losses": torch.equal(loss_a, loss_b),
        "grad_steps": (ts_a.grad_steps, ts_b.grad_steps),
        "filled": buf_a.filled,
    }


# ---------------------------------------------------------------------------
# AlphaZero and PPO against JAX's shard_map iterations
# ---------------------------------------------------------------------------
def f32_actor_critic(state, hidden, dev):
    net = tac.MLPActorCritic(hidden_sizes=hidden, dtype=torch.float32, device=dev)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return net


def az_ppo_rank(rank, world, dev, az_case, ppo_case):
    """One sharded AZ iteration and one sharded PPO iteration on this rank's
    block, with JAX's per-device draws of rank ``rank`` injected."""
    mesh = mesh_mod.make_mesh(device=dev)
    out = {}
    cfg = taz.AZConfig(**az_case["config"])
    net = f32_actor_critic(az_case["params"], cfg.hidden_sizes, dev)
    st = taz.AZState(net=net, optimizer=taz.make_optimizer(cfg, net),
                     env_state=mesh_mod.shard_env_state(planes(az_case["env"], dev), mesh))
    it = sharded_alphazero.make_sharded_az_iteration(cfg, mesh)
    stats = it(st, None, noise=torch.from_numpy(az_case["noise"][rank]),
               perm=torch.from_numpy(az_case["perm"][rank]))
    out["az"] = {"params": to_np(net.state_dict()), "env": to_np(st.env_state),
                 "stats": {k: float(v) for k, v in stats.items()}}

    cfg = tppo.PPOConfig(**ppo_case["config"])
    net = f32_actor_critic(ppo_case["params"], cfg.hidden_sizes, dev)
    opp = f32_actor_critic(ppo_case["opp_params"], cfg.hidden_sizes, dev)
    it = sharded_ppo.make_sharded_ppo_iteration(cfg, mesh, dev)
    env, stats = it(net, opp, tppo.make_optimizer(cfg, net),
                    mesh_mod.shard_env_state(planes(ppo_case["env"], dev), mesh), None,
                    ppo_case["lp"],
                    noise={k: torch.from_numpy(v[rank]) for k, v in ppo_case["noise"].items()},
                    perms=[torch.from_numpy(p) for p in ppo_case["perms"][rank]])
    out["ppo"] = {"params": to_np(net.state_dict()), "env": to_np(env),
                  "stats": {k: float(v) for k, v in stats.items()}}
    return out


def az_world1_rank(rank, world, dev, cfg_kw):
    """World size 1: the sharded AZ iteration and the unsharded one from
    the same seed; whether params, optimizer state and env state are equal
    bit for bit."""
    mesh = mesh_mod.make_mesh(device=dev)
    cfg = taz.AZConfig(**cfg_kw)
    runs = []
    for sharded in (True, False):
        gen = torch.Generator().manual_seed(3)
        st = taz.init_alphazero(cfg, gen)
        it = (sharded_alphazero.make_sharded_az_iteration(cfg, mesh) if sharded
              else taz.make_train_iteration(cfg))
        stats = [it(st, gen) for _ in range(2)]
        runs.append((st, stats))
    (a, sa), (b, sb) = runs
    opt_a, opt_b = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    return {
        "params": all(torch.equal(x, y) for x, y in zip(a.net.state_dict().values(),
                                                       b.net.state_dict().values())),
        "opt": all(torch.equal(opt_a[k][n], opt_b[k][n]) for k in opt_a for n in opt_a[k]),
        "env": all(torch.equal(x, y) for x, y in zip(a.env_state, b.env_state)),
        "loss": [float(s["loss"]) for s in sa] == [float(s["loss"]) for s in sb],
        "episodes": [int(s["episodes"]) for s in sa] == [int(s["episodes"]) for s in sb],
    }


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------
def _state(net):
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def _max_diff(a: dict, b: dict) -> float:
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def tp_rank(rank, world, dev, obs, mask, target, flats, perm):
    """TP forward, a DP x TP train step and a DP x TP AlphaZero conv update,
    each against its replicated twin on the same data.  The AlphaZero nets
    compute in float64: two AdamW steps at lr 1e-2 turn float32 sums in the
    model axis's order into 3.5e-5 on a weight whose gradient is near zero,
    and the case measures the sharding, not that rounding."""
    out = {}
    gen = torch.Generator().manual_seed(0)
    obs, mask, target = (torch.from_numpy(x) for x in (obs, mask, target))
    for mp in (2, 4):
        mesh = mesh_mod.make_mesh(model_parallel=mp, device=dev)
        for dueling in (True, False):
            net = tmlp.QNet(dueling=dueling, dtype=torch.float32, device=dev)
            net.reset_parameters(gen)
            tp_net = tp.shard_params_tp(net, mesh)
            local_obs = tp.shard_batch_dp(obs, mesh)
            with torch.no_grad():
                diff = float((tp_net(local_obs) - net(local_obs)).abs().max())
            out[f"forward_mp{mp}_{'dueling' if dueling else 'plain'}"] = diff
            out[f"shapes_mp{mp}_{'dueling' if dueling else 'plain'}"] = {
                k: tuple(v.shape) for k, v in tp_net.net.state_dict().items()}

    mesh = mesh_mod.make_mesh(model_parallel=2, device=dev)
    net = tmlp.QNet(hidden_sizes=(64, 64), dueling=True, dtype=torch.float32, device=dev)
    net.reset_parameters(gen)
    before = _state(net)
    tp_net = tp.shard_params_tp(net, mesh)
    step = tp.make_tp_train_step(tp_net, torch.optim.Adam(tp_net.parameters(), lr=1e-3), mesh)
    loss = step(*tp.shard_batch_dp((obs, mask, target), mesh))
    rep_opt = torch.optim.Adam(net.parameters(), lr=1e-3)
    rep_loss = ((torch.where(mask, net(obs), 0.0) - target) ** 2).mean()
    rep_loss.backward()
    rep_opt.step()
    full = tp_net.full_state_dict()
    out["step"] = {"loss": (float(loss), float(rep_loss)), "params": _max_diff(full, _state(net)),
                   "moved": min(float((full[k] - before[k]).abs().max()) for k in full),
                   "col_rows": tuple(tp_net.net.hidden[0].weight.shape)}

    cfg = taz.AZConfig(num_envs=16, batch_size=32, updates_per_iter=2, model="conv",
                       channels=16, blocks=1, max_grad_norm=0.5, lr=1e-2)
    ref_net = tac.ConvActorCritic(channels=16, blocks=1, dtype=torch.float64, device=dev)
    ref_net.reset_parameters(gen)
    st = taz.AZState(net=copy.deepcopy(ref_net), optimizer=None,
                     env_state=tbc.reset_planes(cfg.num_envs, dev))
    st.optimizer = taz.make_optimizer(cfg, st.net)
    st_tp = tp.place_dp_tp(st, mesh)
    env_rank = mesh_mod.axis_index(mesh, mesh_mod.ENV_AXIS)
    flat = {k: torch.from_numpy(v) for k, v in flats[env_rank].items()}
    sync = mesh_mod.GradSync(mesh.get_group(mesh_mod.ENV_AXIS))
    local = dataclasses.replace(cfg, batch_size=cfg.batch_size // 2)
    ref = taz.make_update_phase(local, grad_sync=sync)(
        ref_net, taz.make_optimizer(cfg, ref_net), flat, perm=torch.from_numpy(perm))
    got = taz.make_update_phase(local, grad_sync=sync, grad_sq_norm=st_tp.net.grad_sq_norm)(
        st_tp.net, st_tp.optimizer, flat, perm=torch.from_numpy(perm))
    out["az"] = {"loss": max(float((g - r).abs().max()) for g, r in zip(got, ref)),
                 "params": _max_diff(st_tp.net.full_state_dict(), _state(ref_net)),
                 "conv0": tuple(st_tp.net.net.convs[0].weight.shape),
                 "env": tuple(st_tp.env_state.board.shape)}
    return out


# ---------------------------------------------------------------------------
# the collective audit
# ---------------------------------------------------------------------------
def _param_bytes(net) -> int:
    return sum(p.numel() * p.element_size() for p in net.parameters())


def audit_rank(rank, world, dev, dqn_kw, az_kw, ppo_kw):
    """The census and the layout of one DP iteration of each family, and
    of a DQN iteration with the ring, then an env leaf, kept whole."""
    mesh = mesh_mod.make_mesh(device=dev)
    out = {}
    cfg = tdqn.DQNConfig(**dqn_kw)
    init = torch.Generator().manual_seed(0)
    ts = tdqn.init_train_state(cfg, tdqn.make_net(cfg, dev), init)
    env = mesh_mod.shard_env_state(tbc.reset_planes(cfg.num_envs, dev), mesh)
    buf = sharded_train.shard_buffer(trp.make_buffer(cfg.buffer_size, dev), mesh)
    it, _ = sharded_train.make_sharded_train_iteration(cfg, mesh)
    gen = mesh_mod.rank_generator(0, rank, dev)
    (env, buf, _), census = ca.collective_census(it, ts, env, buf, gen)
    out["dqn"] = {"census": census, "param_bytes": _param_bytes(ts.net),
                  "env": ca.local_leaves(env), "ring": ca.local_leaves(buf),
                  "updates": cfg.update_per_collect}

    cfg = taz.AZConfig(**az_kw)
    st = taz.init_alphazero(cfg, init)
    st.env_state = mesh_mod.shard_env_state(st.env_state, mesh)
    it = sharded_alphazero.make_sharded_az_iteration(cfg, mesh)
    _, census = ca.collective_census(it, st, gen)
    out["az"] = {"census": census, "param_bytes": _param_bytes(st.net),
                 "env": ca.local_leaves(st.env_state), "updates": cfg.updates_per_iter}

    cfg = tppo.PPOConfig(**ppo_kw)
    pst = tppo.init_ppo(cfg, init)
    it = sharded_ppo.make_sharded_ppo_iteration(cfg, mesh, dev)
    env = mesh_mod.shard_env_state(pst.env_states[0], mesh)
    (env, _), census = ca.collective_census(it, pst.nets[0], pst.nets[1], pst.optimizers[0],
                                            env, gen, 0)
    out["ppo"] = {"census": census, "param_bytes": _param_bytes(pst.nets[0]),
                  "env": ca.local_leaves(env),
                  "updates": cfg.epochs_per_iter * cfg.minibatches}

    # the regressions: the ring whole on every rank; a board leaf whole
    cfg = tdqn.DQNConfig(**dqn_kw)
    orig_buffer, orig_planes = sharded_train._buffer_specs, mesh_mod.planes_spec
    try:
        sharded_train._buffer_specs = lambda b: trp.ReplayBuffer(*([()] * len(b)))
        ring = sharded_train.shard_buffer(trp.make_buffer(cfg.buffer_size, dev), mesh)
        out["whole_ring"] = ca.local_leaves(ring)
        sharded_train._buffer_specs = orig_buffer
        mesh_mod.planes_spec = lambda x: () if x.dim() == 3 else orig_planes(x)
        env = mesh_mod.shard_env_state(tbc.reset_planes(cfg.num_envs, dev), mesh)
        out["whole_board"] = ca.local_leaves(env)
        it, _ = sharded_train.make_sharded_train_iteration(cfg, mesh)
        try:
            it(ts, env, sharded_train.shard_buffer(trp.make_buffer(cfg.buffer_size, dev), mesh),
               gen)
            out["whole_board_runs"] = True
        except (RuntimeError, IndexError, ValueError):
            out["whole_board_runs"] = False
    finally:
        sharded_train._buffer_specs, mesh_mod.planes_spec = orig_buffer, orig_planes
    return out
