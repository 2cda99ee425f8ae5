"""Port parity for the AlphaZero trainer: the outcome backfill, the loss
and the update phase (global-norm clip + AdamW) against optax, a tiny
``train()``, and exact resume — gobblet_rl_torch against gobblet_rl_tpu on
the CPU.  The self-play segments are in test_torch_az_segment.py.

Tolerances: outcomes exact; the loss and the parameters after the update
phase within 1e-5 in float32 (the frameworks sum in different orders, and
AdamW's decay is applied in another order: torch scales by 1 - lr·wd
before the step, optax adds wd·p to the update).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gobblet_rl_torch.models import actor_critic as tac
from gobblet_rl_torch.models.convert import actor_critic_params_from_flax
from gobblet_rl_torch.ops import batched_core as tbc
from gobblet_rl_torch.search import mcts as tmcts
from gobblet_rl_torch.train import alphazero as taz
from gobblet_rl_torch.train import checkpoint as ckpt
from gobblet_rl_tpu.models import actor_critic as jac
from gobblet_rl_tpu.train import alphazero as jaz
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


def tiny_config(**kw):
    base = dict(num_envs=8, num_sims=6, segment_len=8, temp_moves=2, batch_size=16,
                updates_per_iter=2, iterations=2, model="mlp", hidden_sizes=(32,),
                search="gumbel_lm", max_considered=4)
    base.update(kw)
    return taz.AZConfig(**base)


def random_episodes(L, B, seed):
    rng = np.random.default_rng(seed)
    done = np.zeros((L, B), bool)
    winner = np.zeros((L, B), np.int8)
    player = rng.integers(0, 2, (L, B)).astype(np.int32)
    for b in range(B):
        step = 0
        while step < L:
            end = step + int(rng.integers(2, 9)) - 1
            if end < L:
                done[end, b], winner[end, b] = True, rng.choice([-1, 1])
            step = end + 1
    return done, winner, player, rng.uniform(-1, 1, (L, B)).astype(np.float32)


@pytest.mark.parametrize("bootstrap", [False, True])
def test_assign_outcomes_matches_jax(bootstrap):
    done, winner, player, v = random_episodes(24, 7, 0)
    boot = v if bootstrap else None
    want = jaz.assign_outcomes(jnp.asarray(done), jnp.asarray(winner), jnp.asarray(player),
                               None if boot is None else jnp.asarray(boot))
    got = taz.assign_outcomes(t(done), t(winner), t(player), None if boot is None else t(boot))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool(got[1].all()) == bootstrap   # unfinished tails are valid only when bootstrapped


def flat_batch(n, seed):
    rng = np.random.default_rng(seed)
    mask = rng.random((n, 54)) < 0.4
    mask[np.arange(n), rng.integers(0, 54, n)] = True
    pi = np.where(mask, rng.random((n, 54)), 0).astype(np.float32)
    pi /= pi.sum(-1, keepdims=True)
    return {
        "obs": (rng.random((n, 117)) < 0.2).astype(np.int8),
        "mask": mask,
        "pi": pi,
        "z": rng.choice([-1.0, 0.3, 1.0], n).astype(np.float32),
        "valid": rng.random(n) < 0.8,
    }


@pytest.fixture
def conv_in_float64(model):
    """The conv case's nets compute in float64 (JAX's x64 on for that test,
    then as it was); the MLP's in float32."""
    if model != "conv":
        yield np.float32, jnp.float32, torch.float32
        return
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield np.float64, jnp.float64, torch.float64
    jax.config.update("jax_enable_x64", before)


@pytest.mark.parametrize("model,max_grad_norm", [("mlp", 1.0), ("conv", 1.0), ("mlp", 1e3)])
def test_loss_and_update_phase_match_optax(model, max_grad_norm, conv_in_float64):
    """The loss, then a whole update phase (two minibatches cut from JAX's
    permutation): global-norm clip (triggered at 1.0, not at 1e3) and
    AdamW with weight decay on every parameter.

    The conv nets compute in float64 (their logits are float32): a gradient
    near Adam's eps (1e-8) is float32 rounding noise, and AdamW turns it
    into a parameter gap of up to 2e-5 between two float32 summation
    orders of the convs."""
    np_dtype, jdtype, tdtype = conv_in_float64
    kw = dict(model=model, channels=8, blocks=1, hidden_sizes=(32,), batch_size=48,
              updates_per_iter=2, max_grad_norm=max_grad_norm, lr=1e-2, weight_decay=0.1)
    jcfg, tcfg = jaz.AZConfig(**kw), taz.AZConfig(**kw)
    if model == "conv":
        jnet = jac.ConvActorCritic(channels=8, blocks=1, dtype=jdtype)
        tnet = tac.ConvActorCritic(channels=8, blocks=1, dtype=tdtype, device=CPU)
    else:
        jnet = jac.MLPActorCritic(hidden_sizes=(32,), dtype=jdtype)
        tnet = tac.MLPActorCritic(hidden_sizes=(32,), dtype=tdtype, device=CPU)
    params = jax.tree.map(lambda x: np.asarray(x, np_dtype),
                          jnet.init(jax.random.PRNGKey(1), jnp.zeros((1, 117), jnp.int8)))
    tnet.to(tdtype).load_state_dict(actor_critic_params_from_flax(params, model))
    flat = flat_batch(100, 2)
    jflat = {k: jnp.asarray(v) for k, v in flat.items()}
    tflat = {k: t(v) for k, v in flat.items()}

    jloss, (jp, jv) = jaz.make_loss_fn(jcfg, jnet)(params, jflat)
    with torch.no_grad():
        tloss, (tp, tv) = taz.make_loss_fn(tcfg)(tnet, tflat)
    np.testing.assert_allclose([float(tloss), float(tp), float(tv)],
                               [float(jloss), float(jp), float(jv)], atol=1e-5, rtol=0)

    optimizer = optax.chain(optax.clip_by_global_norm(max_grad_norm),
                            optax.adamw(jcfg.lr, weight_decay=jcfg.weight_decay))
    k_perm = jax.random.PRNGKey(3)
    new_params, _, (losses, p_ls, v_ls) = jaz.make_update_phase(jcfg, jnet, optimizer)(
        params, optimizer.init(params), jflat, k_perm)
    perm = t(jax.random.permutation(k_perm, 100)).long()
    got = taz.make_update_phase(tcfg)(tnet, taz.make_optimizer(tcfg, tnet), tflat, perm=perm)
    for g, w in zip(got, (losses, p_ls, v_ls)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)
    want = actor_critic_params_from_flax(jax.tree.map(np.asarray, new_params), model)
    before = actor_critic_params_from_flax(params, model)
    for name, p in tnet.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-5, rtol=0,
                                   err_msg=name)
        assert not torch.equal(p, before[name]), name  # every parameter moved (decay too)


def test_clip_by_global_norm_matches_optax():
    rng = np.random.default_rng(5)
    grads = [rng.normal(size=s).astype(np.float32) for s in ((4, 3), (7,), (2, 2, 2))]
    for max_norm in (0.5, 100.0):
        want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
        params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
        for p, g in zip(params, grads):
            p.grad = t(g)
        taz.clip_by_global_norm_(params, max_norm)
        for p, w in zip(params, want):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("search", ["gumbel_lm", "puct"])
def test_train_runs_and_updates_params(search):
    config = tiny_config(search=search)
    gen = torch.Generator().manual_seed(0)
    st = taz.init_alphazero(config, gen)
    before = {k: v.clone() for k, v in st.net.state_dict().items()}
    stats = taz.make_train_iteration(config)(st, gen)
    assert np.isfinite(float(stats["loss"])) and float(stats["valid_frac"]) > 0
    assert int(stats["episodes"]) == int(stats["wins_p1"]) + int(stats["wins_p2"])
    assert any(not torch.equal(before[k], v) for k, v in st.net.state_dict().items())
    st2, history = taz.train(tiny_config(search=search), device=CPU)
    assert [h["iteration"] for h in history] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in history)
    assert isinstance(history[0]["episodes"], int)


def states_equal(a, b):
    for (name, x), y in zip(a.net.state_dict().items(), b.net.state_dict().values()):
        assert torch.equal(x, y), name
    for x, y in zip(a.env_state, b.env_state):
        assert torch.equal(x, y)
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    for k in sa:
        for name in sa[k]:
            assert torch.equal(sa[k][name], sb[k][name]), (k, name)


def test_full_resume_is_bit_identical(tmp_path):
    """A run preempted after 2 of 4 iterations and relaunched through
    full_resume_dir ends where the uninterrupted run ends, bit for bit
    (the counterpart of tests/test_alphazero.py:183); a finished schedule
    trains nothing."""
    config = tiny_config(iterations=4)
    straight, hist = taz.train(config, device=CPU)
    d = str(tmp_path / "resume")
    taz.train(dataclasses.replace(config, iterations=2), full_resume_dir=d, device=CPU)
    assert ckpt.latest_step(d) == 1
    resumed, hist2 = taz.train(config, full_resume_dir=d, device=CPU)
    assert [h["iteration"] for h in hist2] == [2, 3]
    assert hist2 == hist[2:]
    states_equal(straight, resumed)
    _, hist3 = taz.train(config, full_resume_dir=d, device=CPU)
    assert hist3 == []


def test_resume_needs_the_generator_and_checkpoint_dir_restores(tmp_path):
    config = tiny_config(iterations=1)
    d = str(tmp_path / "ckpt")
    st, _ = taz.train(config, checkpoint_dir=d, device=CPU)
    assert ckpt.latest_step(d) == 0
    fresh = taz.init_alphazero(config, torch.Generator().manual_seed(9))
    assert ckpt.restore_az(d, fresh) == 0
    states_equal(st, fresh)
    with pytest.raises(RuntimeError, match="generator"):
        ckpt.restore_az(d, fresh, torch.Generator())


def test_az_policy_plays_legal_moves_both_entry_points():
    """az_policy (the lane-major policy) moves as the batch-first
    mcts_policy does, and legally."""
    net = tac.MLPActorCritic(hidden_sizes=(16,), device=CPU)
    net.reset_parameters(torch.Generator().manual_seed(0))
    state = tbc.reset_planes(12, CPU)
    lm = taz.az_policy(net, num_sims=8)
    bf = tmcts.mcts_policy(net, tmcts.MCTSConfig(num_sims=8))
    for _ in range(6):
        a = lm(None, state.board, state.current)
        assert torch.equal(a, bf(None, state.board, state.current))
        assert tbc.legal_mask_planes(state.board, state.current)[a.long(), torch.arange(12)].all()
        state = tbc.autoreset_planes(tbc.step_planes(state, a))
