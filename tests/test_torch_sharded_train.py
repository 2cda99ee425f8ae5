"""Port parity for ``gobblet_rl_torch/parallel/sharded_train.py``, the
data-parallel DQN iteration (the twin of tests/test_sharding.py:23-47),
on spawned gloo ranks that import no JAX (``tests/torch_ranks.py``).

* World size 1: the sharded iteration equals the port's unsharded
  ``make_train_iteration`` from one generator, bit for bit: params, target,
  ring, env state and losses.
* N = 2 and 4: one update synced over the ranks' blocks of a batch equals
  the single-process update on the whole batch and an optax-Adam step of
  the same loss in JAX, within 1e-5.  The nets compute in float64 over
  float32 params (JAX under ``jax.enable_x64``): the frameworks and the
  ranks sum in different orders, which float32 gradients carry through
  Adam's per-weight normalisation; the loss stays float32, as the nets
  return it.  Two iterations keep the invariants:
  ``grad_steps == 2·U``, each rank's ``filled == 2·segment_len·B/N``, one
  digest and one loss on every rank, and distinct draws per rank.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from gobblet_rl_torch.models.convert import qnet_params_from_flax
from gobblet_rl_torch.parallel.multihost import spawn_ranks
from gobblet_rl_torch.train import dqn as tdqn
from gobblet_rl_tpu.models.mlp import masked_q
from tests import torch_ranks
from tests.test_torch_dqn import flax_params, random_batch, torch_qnet

HIDDEN = (32, 32)
ITER = dict(num_envs=64, buffer_size=2048, batch_size=64, segment_len=4, update_per_collect=2,
            opponent="random", hidden_sizes=HIDDEN)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes on a few cores, where torch's thread pools would oversubscribe
    them and small ops slow down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_world_size_one_equals_unsharded():
    (res,) = spawn_ranks(torch_ranks.dqn_world1_rank, 1,
                         ({**ITER, "learner_player": "both", "target_update_freq": 2}, 2),
                         device="cpu", timeout=120)
    assert res["grad_steps"] == (4, 4) and res["filled"] == 2 * 4 * 64
    for k in ("params", "target", "ring", "env", "losses"):
        assert res[k], k


def optax_update(params, target, batch, config):
    """The sharded update's math in JAX (sharded_train.py:104-127) on the
    whole batch: double-DQN target, MSE, one optax Adam step."""
    jnet, _ = flax_params(HIDDEN, True, dtype=jax.numpy.float64)
    obs, action, reward_n, done_n, obs_n, mask_n = map(jax.numpy.asarray, batch)
    q_next = masked_q(jnet.apply(target, obs_n), mask_n)
    a_star = jax.numpy.argmax(masked_q(jnet.apply(params, obs_n), mask_n), axis=-1)
    q_star = jax.numpy.take_along_axis(q_next, a_star[:, None], axis=-1)[:, 0]
    y = reward_n + (config.gamma ** config.n_step) * (~done_n) * q_star

    def loss_fn(p):
        q = jnet.apply(p, obs)
        return jax.numpy.mean((jax.numpy.take_along_axis(q, action[:, None], axis=-1)[:, 0]
                               - y) ** 2)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    opt = optax.adam(config.lr)
    updates, _ = opt.update(grads, opt.init(params), params)
    return float(loss), optax.apply_updates(params, updates)


@pytest.mark.parametrize("n", [2, 4])
def test_synced_update_and_iterations(n):
    config = tdqn.DQNConfig(hidden_sizes=HIDDEN, lr=1e-3)
    _, params = flax_params(HIDDEN, True, seed=3)
    target = jax.tree.map(lambda x: x + 0.05, params)
    batch = random_batch(256, 7)
    p_np = {k: v.numpy() for k, v in qnet_params_from_flax(params, True).items()}
    t_np = {k: v.numpy() for k, v in qnet_params_from_flax(target, True).items()}
    updates = spawn_ranks(torch_ranks.dqn_update_rank, n,
                          (p_np, t_np, batch, HIDDEN, {"hidden_sizes": HIDDEN, "lr": 1e-3}),
                          device="cpu", timeout=120)
    its = spawn_ranks(torch_ranks.dqn_iterations_rank, n, (ITER, 2), device="cpu", timeout=120)

    # the single-process update of the port on the whole batch
    ts = tdqn.TrainState(net=torch_qnet(params, HIDDEN, True, torch.float64),
                         target_net=torch_qnet(target, HIDDEN, True, torch.float64),
                         opponent_net=torch_qnet(params, HIDDEN, True, torch.float64),
                         optimizer=None)
    ts.optimizer = torch.optim.Adam(ts.net.parameters(), lr=config.lr, betas=(0.9, 0.999),
                                    eps=1e-8)
    whole_loss = float(tdqn.update(config, ts, tuple(map(torch.from_numpy, batch))))
    with jax.enable_x64(True):
        jloss, jparams = optax_update(params, target, batch, config)
    want = qnet_params_from_flax(jax.tree.map(np.asarray, jparams), True)
    for r, res in enumerate(updates):
        assert res["grad_steps"] == 1
        np.testing.assert_allclose(res["loss"], [whole_loss, jloss], atol=1e-5, rtol=0)
        for name, got in res["params"].items():
            np.testing.assert_allclose(got, ts.net.state_dict()[name].numpy(), atol=1e-5,
                                       rtol=0, err_msg=f"{name} on rank {r}")
            np.testing.assert_allclose(got, want[name].numpy(), atol=1e-5, rtol=0,
                                       err_msg=f"{name} on rank {r} against optax")
        assert all(np.array_equal(v, updates[0]["params"][k]) for k, v in res["params"].items())
    moved = max(float(np.abs(updates[0]["params"][k] - v).max()) for k, v in p_np.items())
    assert moved > 1e-4

    U, S = ITER["update_per_collect"], ITER["segment_len"]
    for res in its:
        assert res["grad_steps"] == 2 * U
        assert res["filled"] == res["cursor"] == 2 * S * ITER["num_envs"] // n
        assert res["rows"] == ITER["buffer_size"] // n and res["envs"] == ITER["num_envs"] // n
        assert all(np.isfinite(res["losses"]))
    assert len({r["digest"] for r in its}) == 1
    assert len({tuple(r["losses"]) for r in its}) == 1
    assert len({r["actions"].tobytes() for r in its}) == n   # each rank its own draws
