"""The defense bank with ``sides="both"`` against JAX's, row for row under
JAX's draws (the ``"defense"`` case is in test_torch_defense.py; each
file's builds take tens of seconds of solver time, so they are split), and
the bank's loss term in the PPO and DQN updates against the JAX trainers'
own ``loss_fn`` and ``update`` (taken from their closures) on float32 nets:
within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gobblet_rl_torch.models import actor_critic as tac
from gobblet_rl_torch.models import mlp as tmlp
from gobblet_rl_torch.models.convert import actor_critic_params_from_flax, qnet_params_from_flax
from gobblet_rl_torch.native import engine as tengine
from gobblet_rl_torch.train import defense as tdefense
from gobblet_rl_torch.train import dqn as tdqn
from gobblet_rl_torch.train import ppo as tppo
from gobblet_rl_tpu.models import actor_critic as jac
from gobblet_rl_tpu.models.mlp import QNet
from gobblet_rl_tpu.native import engine as jengine
from gobblet_rl_tpu.train import dqn as jdqn
from gobblet_rl_tpu.train import ppo as jppo
from tests.test_torch_defense import assert_banks_equal, build_both
from tests.torch_parity import CPU, t


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes on a few cores, where torch's thread pools would oversubscribe
    them and small ops slow down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def release_tables():
    yield
    tengine.solve_tt_clear()
    jengine.solve_tt_clear()


def closure(jitted, name):
    """A free variable of a jitted JAX function (the trainers' inner
    ``loss_fn`` and ``update``)."""
    f = jitted.__wrapped__
    return dict(zip(f.__code__.co_freevars, (c.cell_contents for c in f.__closure__)))[name]


def test_bank_equals_jax_under_jax_draws_both_sides():
    want, got = build_both("both", 8, 12, 5)
    assert_banks_equal(want, got, games=8)


def synthetic_bank(n, seed):
    rng = np.random.default_rng(seed)
    mask = rng.random((n, 54)) < 0.3
    action = rng.integers(0, 54, n).astype(np.int32)
    mask[np.arange(n), action] = True
    return {"obs": (rng.random((n, 117)) < 0.2).astype(np.int8), "mask": mask, "action": action}


def ppo_batch(n, seed):
    rng = np.random.default_rng(seed)
    b = synthetic_bank(n, seed)
    return {"obs": b["obs"], "mask": b["mask"], "action": b["action"],
            "logp": rng.uniform(-4, -0.5, n).astype(np.float32),
            "adv": rng.normal(size=n).astype(np.float32),
            "ret": rng.uniform(-1, 1, n).astype(np.float32)}


def test_ppo_bank_term_matches_jax():
    kw = dict(hidden_sizes=(32,), defense_bc_weight=0.7, num_envs=8, segment_len=4)
    jnet = jac.MLPActorCritic(hidden_sizes=(32,), dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jnet.init(jax.random.PRNGKey(2), jnp.zeros((1, 117), jnp.int8)))
    tnet = tac.MLPActorCritic(hidden_sizes=(32,), dtype=torch.float32, device=CPU)
    tnet.load_state_dict(actor_critic_params_from_flax(params, "mlp"))
    bank, batch = synthetic_bank(40, 3), ppo_batch(64, 4)
    jbank = {k: jnp.asarray(v) for k, v in bank.items()}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbank = tdefense.bank_tensors(bank, CPU)
    tbatch = {k: t(v) for k, v in batch.items()}
    totals = {}
    for with_bank in (False, True):
        jcfg = jppo.PPOConfig(**kw)
        jloss_fn = closure(jppo.make_train_iteration(jcfg, jnet, optax.adam(1e-3), "random",
                                                     jbank if with_bank else None), "loss_fn")
        jtotal, _ = jloss_fn(params, jbatch)
        with torch.no_grad():
            ttotal, _ = tppo.make_loss_fn(tppo.PPOConfig(**kw), tbank if with_bank else None)(
                tnet, tbatch)
        np.testing.assert_allclose(float(ttotal), float(jtotal), atol=1e-5, rtol=0)
        totals[with_bank] = (float(ttotal), float(jtotal))
    with torch.no_grad():
        term = float(tdefense.bank_loss(tnet(tbank["obs"])[0], tbank))
    np.testing.assert_allclose(0.7 * term, totals[True][1] - totals[False][1], atol=1e-5)
    assert term > 1.0


def test_dqn_bank_term_matches_jax():
    """One whole DQN update with the bank (double-DQN target, MSE plus the
    weighted cross-entropy over masked Q, Adam): the loss and the new
    parameters."""
    hidden = (32, 32)
    kw = dict(hidden_sizes=hidden, defense_bc_weight=0.5, lr=1e-3)
    jnet = QNet(hidden_sizes=hidden, dueling=True, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jnet.init(jax.random.PRNGKey(4), jnp.zeros((1, 117), jnp.int8)))
    target = jax.tree.map(lambda x: x + 0.05, params)
    bank = synthetic_bank(48, 5)
    rng = np.random.default_rng(6)
    b = synthetic_bank(128, 7)
    batch = (b["obs"], b["action"], rng.choice([-1.0, 0.0, 0.81], 128).astype(np.float32),
             rng.random(128) < 0.3, synthetic_bank(128, 8)["obs"], b["mask"])
    jcfg = jdqn.DQNConfig(**kw)
    opt = optax.adam(jcfg.lr)
    it, _ = jdqn.make_train_iteration(jcfg, jnet, opt, {k: jnp.asarray(v) for k, v in bank.items()})
    jts = jdqn.TrainState(params=params, target_params=target, opponent_params=params,
                          opt_state=opt.init(params), grad_steps=jnp.int32(0))
    jts, jloss = jax.jit(closure(it, "update"))(jts, tuple(map(jnp.asarray, batch)))

    def qnet(p):
        net = tmlp.QNet(hidden_sizes=hidden, dueling=True, dtype=torch.float32, device=CPU)
        net.load_state_dict(qnet_params_from_flax(p, True))
        return net

    net = qnet(params)
    ts = tdqn.TrainState(net=net, target_net=qnet(target), opponent_net=qnet(params),
                         optimizer=torch.optim.Adam(net.parameters(), lr=1e-3, eps=1e-8))
    tloss = tdqn.update(tdqn.DQNConfig(**kw), ts, tuple(map(torch.from_numpy, batch)),
                        tdefense.bank_tensors(bank, CPU))
    np.testing.assert_allclose(float(tloss), float(jloss), atol=1e-5, rtol=0)
    want = qnet_params_from_flax(jax.tree.map(np.asarray, jts.params), True)
    for name, p in net.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-5, rtol=0, err_msg=name)
