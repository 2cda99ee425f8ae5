"""Port parity for ``gobblet_rl_torch/parallel/sharded_alphazero.py`` and
``sharded_ppo.py``: two torch gloo ranks (``tests/torch_ranks.py``, no
JAX) against JAX's ``make_sharded_az_iteration`` and
``make_sharded_ppo_iteration`` on ``make_mesh(2)`` of the virtual CPU
devices, on the exact float32 nets of ``torch_parity.py``.

JAX's device ``r`` folds the key with ``r``; each rank gets the fields
and permutations rebuilt from ``fold_in(key, r)`` (as
test_torch_az_segment.py and test_torch_ppo.py rebuild them) through
``noise=`` and ``perm=``/``perms=``.

* The final env batch, episodes and valid fraction are identical (the
  trajectories are); the loss, mean reward and params after one iteration
  within 1e-5 (float32 sums in different orders).
* The AZ case clips (``max_grad_norm`` below every gradient's norm), so
  the order "average over ranks, then clip" is pinned: clipping each
  rank's gradients first moves the params by ~lr elsewhere.
* The PPO case normalises with the global advantage moments: the
  unsharded iteration, which normalises per minibatch, lands elsewhere.
* World size 1: the sharded AZ iteration equals the unsharded one, bit
  for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gobblet_rl_torch.models.convert import actor_critic_params_from_flax
from gobblet_rl_torch.ops import batched_core as tbc
from gobblet_rl_torch.parallel.multihost import spawn_ranks
from gobblet_rl_torch.train import ppo as tppo
from gobblet_rl_tpu.ops import batched_core as jbc
from gobblet_rl_tpu.parallel import mesh as jmesh
from gobblet_rl_tpu.parallel import sharded_alphazero as jsaz
from gobblet_rl_tpu.parallel import sharded_ppo as jsppo
from gobblet_rl_tpu.train import alphazero as jaz
from gobblet_rl_tpu.train import ppo as jppo
from tests import torch_ranks
from tests.test_torch_ppo_rollout import start_state
from tests.torch_parity import exact_nets, t

N = 2
AZ = dict(num_envs=16, num_sims=6, segment_len=8, search="gumbel_lm", max_considered=4,
          model="mlp", hidden_sizes=(64,), batch_size=32, updates_per_iter=2,
          max_grad_norm=0.05, lr=1e-2, weight_decay=0.1)
# The PPO nets have no hidden layer: with one, a ReLU whose input sits at
# zero after an update flips one row's gradient under float32 reordering,
# and Adam's normalisation inflates that to ~lr a step (one unit of a
# 64-wide layer ended 2.9e-3 off after 8 updates, JAX against the port).
PPO = dict(num_envs=16, segment_len=8, shared_policy=True, learner_player="both",
           opponent="self", hidden_sizes=(), epochs_per_iter=2, minibatches=4, lr=1e-3,
           max_grad_norm=0.5)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes on a few cores, where torch's thread pools would oversubscribe
    them and small ops slow down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def state_np(params, model="mlp"):
    return {k: v.numpy() for k, v in actor_critic_params_from_flax(params, model).items()}


def az_case(key):
    """JAX's sharded AZ iteration, and what the torch ranks need to replay it."""
    jnet, params, _ = exact_nets()
    cfg = jaz.AZConfig(**AZ)
    optimizer = optax.chain(optax.clip_by_global_norm(cfg.max_grad_norm),
                            optax.adamw(cfg.lr, weight_decay=cfg.weight_decay))
    mesh = jmesh.make_mesh(N)
    env = jbc.reset_planes(cfg.num_envs)
    it = jsaz.make_sharded_az_iteration(cfg, jnet, optimizer, mesh)
    out = it(params, optimizer.init(params), jmesh.shard_env_state(env, mesh), key)
    b, L = cfg.num_envs // N, cfg.segment_len
    noise, perm = [], []
    for r in range(N):
        k, k_roll, k_perm = jax.random.split(jax.random.fold_in(key, r), 3)
        fields, k = [], k_roll
        for _ in range(L):
            k, k_search = jax.random.split(k)
            fields.append(np.asarray(jax.random.gumbel(k_search, (54, b), jnp.float32)))
        noise.append(np.stack(fields))
        perm.append(np.asarray(jax.random.permutation(k_perm, L * b)).astype(np.int64))
    case = {"config": AZ, "params": state_np(params), "env": tuple(np.asarray(x) for x in env),
            "noise": noise, "perm": perm}
    return out, case


def ppo_case(key):
    jnet, params, _ = exact_nets(hidden=())
    _, opp_params, _ = exact_nets(hidden=(), seed=1)
    cfg = jppo.PPOConfig(**PPO)
    optimizer = optax.chain(optax.clip_by_global_norm(cfg.max_grad_norm), optax.adam(cfg.lr))
    mesh = jmesh.make_mesh(N)
    env, _ = start_state(cfg, cfg.learner_player, opp_params, 4)
    it = jsppo.make_sharded_ppo_iteration(cfg, jnet, optimizer, mesh)
    out = it(params, opp_params, optimizer.init(params), jmesh.shard_env_state(env, mesh), key,
             cfg.learner_player)
    b, L = cfg.num_envs // N, cfg.segment_len
    noise, perms = {"act": [], "opp": [], "open": []}, []
    for r in range(N):
        _, k_roll = jax.random.split(jax.random.fold_in(key, r))
        k, fields = k_roll, {"act": [], "opp": [], "open": []}
        for _ in range(L):
            k, k_act, k_step = jax.random.split(k, 3)
            k1, k2 = jax.random.split(k_step)
            fields["act"].append(jax.random.gumbel(k_act, (b, 54), jnp.float32))
            fields["opp"].append(jax.random.gumbel(k1, (b, 54), jnp.float32))
            fields["open"].append(jax.random.gumbel(k2, (b, 54), jnp.float32))
        for name, v in fields.items():
            noise[name].append(np.stack([np.asarray(x) for x in v]))
        rank_perms = []
        for _ in range(cfg.epochs_per_iter):
            k, k_perm = jax.random.split(k)
            rank_perms.append(np.asarray(jax.random.permutation(k_perm, L * b)).astype(np.int64))
        perms.append(rank_perms)
    case = {"config": PPO, "params": state_np(params), "opp_params": state_np(opp_params),
            "env": tuple(np.asarray(x) for x in env), "lp": cfg.learner_player,
            "noise": noise, "perms": perms}
    return out, case


@pytest.fixture(scope="module")
def runs():
    (jaz_out, az_in), (jppo_out, ppo_in) = az_case(jax.random.PRNGKey(1)), ppo_case(
        jax.random.PRNGKey(2))
    ranks = spawn_ranks(torch_ranks.az_ppo_rank, N, (az_in, ppo_in), device="cpu", timeout=180)
    return {"az": (jaz_out, az_in), "ppo": (jppo_out, ppo_in), "ranks": ranks}


def assert_iteration_equals_jax(jparams, jenv, jstats, ranks, family, before):
    want = actor_critic_params_from_flax(jax.tree.map(np.asarray, jparams), "mlp")
    for r, res in enumerate(ranks):
        got = res[family]
        for name, p in got["params"].items():
            np.testing.assert_allclose(p, want[name].numpy(), atol=1e-5, rtol=0,
                                       err_msg=f"{family} {name} on rank {r}")
            assert not np.array_equal(p, before[name]), name
        for name, leaf, block in zip(jbc.PlanesState._fields, jenv, got["env"]):
            np.testing.assert_array_equal(block, np.asarray(leaf.addressable_shards[r].data),
                                          err_msg=f"{family} {name} on rank {r}")
        assert got["stats"] == ranks[0][family]["stats"]   # one answer on every rank
    stats = ranks[0][family]["stats"]
    assert stats["episodes"] == int(jstats["episodes"]) > 0
    for k in stats:
        np.testing.assert_allclose(stats[k], float(jstats[k]), atol=1e-5, rtol=0, err_msg=k)


def test_sharded_az_equals_jax_and_clips_after_the_sync(runs):
    (jparams, _, jenv, jstats), az_in = runs["az"]
    assert_iteration_equals_jax(jparams, jenv, jstats, runs["ranks"], "az", az_in["params"])
    assert set(jstats) == set(runs["ranks"][0]["az"]["stats"])


def test_sharded_ppo_equals_jax_with_global_moments(runs):
    (jparams, _, jenv, jstats), ppo_in = runs["ppo"]
    assert_iteration_equals_jax(jparams, jenv, jstats, runs["ranks"], "ppo", ppo_in["params"])
    # the unsharded iteration normalises per minibatch: on rank 0's block
    # with rank 0's draws it lands elsewhere
    _, _, tnet = exact_nets(hidden=())
    _, _, opp = exact_nets(hidden=(), seed=1)
    cfg = tppo.PPOConfig(**{**PPO, "num_envs": PPO["num_envs"] // N})
    env = tbc.PlanesState(*(t(np.ascontiguousarray(x[..., :cfg.num_envs])) for x in ppo_in["env"]))
    tppo.make_train_iteration(cfg, device="cpu")(
        tnet, opp, tppo.make_optimizer(cfg, tnet), env, None, PPO["learner_player"],
        noise={k: t(v[0]) for k, v in ppo_in["noise"].items()},
        perms=[t(p) for p in ppo_in["perms"][0]])
    sharded = runs["ranks"][0]["ppo"]["params"]
    assert max(float(np.abs(v.numpy() - sharded[k]).max())
               for k, v in tnet.state_dict().items()) > 1e-4


def test_world_size_one_az_equals_unsharded():
    (res,) = spawn_ranks(torch_ranks.az_world1_rank, 1,
                         (dict(num_envs=8, num_sims=4, segment_len=6, temp_moves=2, batch_size=16,
                               updates_per_iter=2, model="mlp", hidden_sizes=(16,)),),
                         device="cpu", timeout=120)
    for k in ("params", "opt", "env", "loss", "episodes"):
        assert res[k], k
