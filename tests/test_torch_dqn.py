"""Port parity for the DQN slice: QNet through the flax converter, the
replay ring, the learner step as a whole, one double-DQN update with Adam,
and a train-iteration smoke test — gobblet_rl_torch against
gobblet_rl_tpu on the CPU.

Integer state and replay rows must match bit for bit.  Float tolerances:
float32 Q-values within atol 1e-5 (the two frameworks sum the matrix
products in different orders); bfloat16 Q-values within 2e-2 of max |Q|
(bf16 keeps 8 bits of mantissa and the two frameworks round at different
places); parameters after one Adam step within atol 1e-5.
"""

from dataclasses import replace as dataclasses_replace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gobblet_rl_torch.models import mlp as tmlp
from gobblet_rl_torch.models.convert import qnet_params_from_flax
from gobblet_rl_torch.ops import batched_core as tbc
from gobblet_rl_torch.policies import greedy_jax as greedy_jax_torch
from gobblet_rl_torch.train import checkpoint as ckpt
from gobblet_rl_torch.train import dqn as tdqn
from gobblet_rl_torch.train import replay as trp
from gobblet_rl_tpu.models.mlp import QNet, masked_q
from gobblet_rl_tpu.ops import batched_core as jbc
from gobblet_rl_tpu.train import dqn as jdqn
from gobblet_rl_tpu.train import replay as jrp

CPU = torch.device("cpu")
HIDDEN = (32, 32)


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
def release_solver_table():
    """The defense term's bank runs the native solver, whose table is 2 GiB
    once touched; release it at the end of the module."""
    yield
    from gobblet_rl_torch.native import engine

    engine.solve_tt_clear()


def flax_params(hidden, dueling, seed=0, dtype=jnp.float32):
    net = QNet(hidden_sizes=hidden, dueling=dueling, dtype=dtype)
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, 117), jnp.int8))
    return net, jax.tree.map(np.asarray, params)


def torch_qnet(params_np, hidden, dueling, dtype=torch.float32):
    net = tmlp.QNet(hidden_sizes=hidden, dueling=dueling, dtype=dtype, device=CPU)
    net.load_state_dict(qnet_params_from_flax(params_np, dueling))
    return net


def random_obs(n, seed):
    return (np.random.default_rng(seed).random((n, 117)) < 0.2).astype(np.int8)


@pytest.mark.parametrize("dueling", [True, False])
def test_qnet_float32_matches_flax(dueling):
    jnet, params = flax_params((32, 32, 32), dueling)
    tnet = torch_qnet(params, (32, 32, 32), dueling)
    obs = random_obs(64, 1)
    want = np.asarray(jnet.apply(params, jnp.asarray(obs)))
    got = tnet(torch.from_numpy(obs)).detach().numpy()
    assert got.dtype == np.float32 and got.shape == (64, 54)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dueling", [True, False])
def test_qnet_bf16_matches_flax(dueling):
    jnet, params = flax_params(HIDDEN, dueling, dtype=jnp.bfloat16)
    tnet = torch_qnet(params, HIDDEN, dueling, dtype=torch.bfloat16)
    obs = random_obs(64, 2)
    want = np.asarray(jnet.apply(params, jnp.asarray(obs)))
    got = tnet(torch.from_numpy(obs)).detach().numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-2 * np.abs(want).max(), rtol=0)


def test_converter_layout_and_dueling_head():
    _, params = flax_params((32,), True)
    sd = qnet_params_from_flax(params, dueling=True)
    assert sd["hidden.0.weight"].shape == (32, 117)
    assert sd["head.weight"].shape == (54, 32)      # Dense_1: advantage stream
    assert sd["value.weight"].shape == (1, 32)      # Dense_2: value stream
    np.testing.assert_array_equal(sd["head.weight"].numpy(),
                                  params["params"]["Dense_1"]["kernel"].T)
    net = tmlp.QNet(hidden_sizes=(32,), dueling=True, device=CPU)
    net.load_state_dict(sd)
    with pytest.raises(ValueError):
        qnet_params_from_flax({"params": {"Dense_0": params["params"]["Dense_0"]}}, True)


def test_masked_argmax_first_index_on_ties():
    q = torch.tensor([[1.0, 3.0, 3.0, 0.5], [2.0, 2.0, 2.0, 2.0]])
    mask = torch.tensor([[True, True, True, True], [False, True, True, True]])
    np.testing.assert_array_equal(tmlp.masked_argmax(q, mask).numpy(), [1, 1])
    assert tmlp.masked_q(q, mask)[1, 0] == -torch.inf
    want = np.asarray(jnp.argmax(masked_q(jnp.asarray(q.numpy()), jnp.asarray(mask.numpy())), -1))
    np.testing.assert_array_equal(tmlp.masked_argmax(q, mask).numpy(), want)


def test_qnet_init_from_generator_is_reproducible():
    def make(seed):
        net = tmlp.QNet(hidden_sizes=HIDDEN, dueling=True, device=CPU)
        net.reset_parameters(torch.Generator().manual_seed(seed))
        return net
    a, b, c = make(0), make(0), make(1)
    for (name, pa), pb, pc in zip(a.state_dict().items(), b.state_dict().values(),
                                  c.state_dict().values()):
        assert torch.equal(pa, pb), name
        if name.endswith("weight"):
            assert not torch.equal(pa, pc)
            # LeCun truncated normal: |w| <= 2 std, std = 1/sqrt(fan_in)/0.8796
            std = (1 / np.sqrt(pa.shape[1])) / 0.87962566103423978
            assert float(pa.abs().max()) <= 2 * std + 1e-6
        else:
            assert not pa.any()


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------
def random_state_segment(L, B, seed):
    rng = np.random.default_rng(seed)
    board = rng.integers(-6, 7, (L + 1, 3, 9, B)).astype(np.int8)
    current = rng.integers(0, 2, (L + 1, B)).astype(np.int32)
    action = rng.integers(0, 54, (L, B)).astype(np.int32)
    reward = rng.choice([-1.0, 0.0, 1.0], (L, B)).astype(np.float32)
    done = rng.random((L, B)) < 0.25
    return (board, current, action, reward, done)


def assert_rows_equal(trows, jrows):
    for field, t, j in zip(jrp.TransitionBatch._fields, trows, jrows):
        j = np.asarray(j)
        assert t.numpy().dtype == j.dtype, field
        np.testing.assert_array_equal(t.numpy(), j, err_msg=field)


def test_nstep_fold_state_matches():
    S, n, B = 6, 3, 16
    arrays = random_state_segment(S + n - 1, B, 0)
    j = jrp.nstep_fold_state(jrp.StateSegment(*map(jnp.asarray, arrays)), n, 0.9, S)
    t = trp.nstep_fold_state(trp.StateSegment(*map(torch.from_numpy, arrays)), n, 0.9, S)
    assert_rows_equal(t, j)


def make_rows(n, base, seed):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(-6, 7, (n, 27)).astype(np.int8),
        rng.integers(0, 2, n).astype(np.int8),
        (base + np.arange(n)).astype(np.int32),
        rng.random(n).astype(np.float32),
        rng.random(n) < 0.5,
        rng.integers(-6, 7, (n, 27)).astype(np.int8),
        rng.integers(0, 2, n).astype(np.int8),
    )


def assert_buffers_equal(tbuf, jbuf):
    for field in jrp.ReplayBuffer._fields:
        j, t = np.asarray(getattr(jbuf, field)), getattr(tbuf, field)
        if isinstance(t, int):
            assert t == int(j), field
        else:
            np.testing.assert_array_equal(t.numpy(), j, err_msg=field)


@pytest.mark.parametrize("capacity,sizes", [
    (256, [128, 128, 128]),          # count-aligned: contiguous copies, wraps at the end
    (96, [40, 40, 40, 40]),          # unaligned: the cursor wraps mid-insert
    (64, [96, 16]),                  # oversized insert: newest rows, cursor reset to 0
    (64, [64, 64, 10]),              # exactly capacity rows (the full-width case)
])
def test_insert_rows_matches(capacity, sizes):
    jbuf, tbuf = jrp.make_buffer(capacity), trp.make_buffer(capacity, CPU)
    for i, n in enumerate(sizes):
        rows = make_rows(n, 100 * (i + 1), i)
        jbuf = jrp.insert_rows(jbuf, jrp.TransitionBatch(*map(jnp.asarray, rows)))
        tbuf = trp.insert_rows(tbuf, trp.TransitionBatch(*map(torch.from_numpy, rows)))
        assert_buffers_equal(tbuf, jbuf)


def test_derive_features_and_sample():
    n = 200
    rng = np.random.default_rng(4)
    # reachable boards: snapshots of an engine run
    g = rng.gumbel(size=(12, 54, n)).astype(np.float32)
    s, _ = tbc.rollout_random(tbc.reset_planes(n, CPU), None, 12, torch.from_numpy(g))
    board_rows = s.board.permute(2, 0, 1).reshape(n, 27).numpy()
    current_rows = s.current.to(torch.int8).numpy()
    idx = rng.integers(0, n, 64)
    jo, jm = jrp.derive_features(jnp.asarray(board_rows[idx]), jnp.asarray(current_rows[idx]))
    to, tm = trp.derive_features(torch.from_numpy(board_rows[idx]),
                                 torch.from_numpy(current_rows[idx]))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))

    buf = trp.make_buffer(256, CPU)
    buf = trp.insert_rows(buf, trp.TransitionBatch(*map(torch.from_numpy, make_rows(128, 0, 5))))
    obs, action, r, d, obs_n, mask_n = trp.sample(buf, torch.Generator().manual_seed(0), 64)
    assert obs.shape == (64, 117) and obs.dtype == torch.int8
    assert mask_n.shape == (64, 54) and mask_n.dtype == torch.bool
    assert int(action.max()) < 128  # only the filled prefix is drawn


# ---------------------------------------------------------------------------
# the slice as a whole: learner steps + segment insert
# ---------------------------------------------------------------------------
def integer_params(hidden, dueling, seed):
    """flax-shaped parameters with values in -2..2: every product and sum of
    the forward pass is an exact float32 integer (below 2**24 at these
    widths), so both frameworks compute the same Q-values and take the
    same argmax."""
    _, params = flax_params(hidden, dueling)
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: rng.integers(-2, 3, x.shape).astype(np.float32), params)


@pytest.mark.parametrize("learner_player", [0, "both"])
def test_learner_steps_and_segment_match(learner_player):
    """Learner steps in both frameworks (opponent = the same net): a few
    warm-up steps with numpy-chosen learner moves spread the envs over
    varied positions, then L recorded steps with the net's argmax moves."""
    S, n_step, B, warmup = 16, 3, 64, 6
    L = S + n_step - 1
    config = jdqn.DQNConfig(opponent="self", eps_train=0.0, learner_player=learner_player,
                            num_envs=B, segment_len=S, n_step=n_step, hidden_sizes=HIDDEN)
    tconfig = tdqn.DQNConfig(**{f: getattr(config, f) for f in config.__dataclass_fields__})
    params = integer_params(HIDDEN, True, seed=1)
    jnet = QNet(hidden_sizes=HIDDEN, dueling=True, dtype=jnp.float32)
    tnet = torch_qnet(params, HIDDEN, True)

    j_opp = jdqn.make_opponent_fn(config, jnet)
    j_step = jax.jit(jdqn.make_learner_step(config, j_opp))
    t_opp = tdqn.make_opponent_fn(tconfig)
    t_step = tdqn.make_learner_step(tconfig, t_opp)
    gen = torch.Generator().manual_seed(0)

    key = jax.random.PRNGKey(0)
    js = jdqn.init_env_state(config, j_opp, params, key)
    ts = tdqn.init_env_state(tconfig, t_opp, tnet, gen)
    rng = np.random.default_rng(learner_player == "both")
    jseg = {k: [] for k in ("board", "current", "action", "reward", "done")}
    tseg = {k: [] for k in jseg}
    with torch.no_grad():
        for t in range(-warmup, L):
            if t >= 0:
                for seg, s in ((jseg, js), (tseg, ts)):
                    seg["board"].append(np.asarray(s.board))
                    seg["current"].append(np.asarray(s.current))
                ja = np.asarray(j_opp(None, js.board, js.current, params))  # the net's argmax
                ta = t_opp(None, ts.board, ts.current, tnet)
                np.testing.assert_array_equal(ta.numpy(), ja, err_msg=f"actions at {t}")
            else:
                mask = tbc.legal_mask_planes(ts.board, ts.current).numpy().T
                ja = np.array([rng.choice(np.nonzero(m)[0]) for m in mask], np.int32)
                ta = torch.from_numpy(ja)
            js, jr, jd = j_step(js, jnp.asarray(ja), key, params)
            ts, tr, td = t_step(ts, ta, gen, tnet)
            for field, j, x in zip(jbc.PlanesState._fields, js, ts):
                np.testing.assert_array_equal(x.numpy(), np.asarray(j), err_msg=f"{field} at {t}")
            np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
            np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
            if t < 0:
                continue
            for seg, a, r, d in ((jseg, ja, jr, jd), (tseg, ta, tr, td)):
                seg["action"].append(np.asarray(a))
                seg["reward"].append(np.asarray(r))
                seg["done"].append(np.asarray(d))
    for seg, s in ((jseg, js), (tseg, ts)):
        seg["board"].append(np.asarray(s.board))
        seg["current"].append(np.asarray(s.current))
    assert np.stack(jseg["done"]).any(), "the segment must contain finished games"

    fields = ("board", "current", "action", "reward", "done")
    jbuf = jrp.insert_segment(
        jrp.make_buffer(S * B),
        jrp.StateSegment(*(jnp.asarray(np.stack(jseg[f])) for f in fields)), n_step, 0.9, S)
    tbuf = trp.insert_segment(
        trp.make_buffer(S * B, CPU),
        trp.StateSegment(*(torch.from_numpy(np.stack(tseg[f])) for f in fields)), n_step, 0.9, S)
    assert_buffers_equal(tbuf, jbuf)


# ---------------------------------------------------------------------------
# one update on a fixed batch
# ---------------------------------------------------------------------------
def random_batch(N, seed):
    rng = np.random.default_rng(seed)
    mask_n = rng.random((N, 54)) < 0.5
    mask_n[np.arange(N), rng.integers(0, 54, N)] = True
    return (
        random_obs(N, seed),
        rng.integers(0, 54, N).astype(np.int32),
        rng.choice([-1.0, 0.0, 0.81, 1.0], N).astype(np.float32),
        rng.random(N) < 0.3,
        random_obs(N, seed + 1),
        mask_n,
    )


@pytest.mark.parametrize("double", [True, False])
def test_one_update_matches_optax(double):
    config = jdqn.DQNConfig(hidden_sizes=HIDDEN, double=double)
    jnet, params = flax_params(HIDDEN, True, seed=3)
    target = jax.tree.map(lambda x: x + 0.05, params)
    batch = random_batch(256, 7)
    obs, action, reward_n, done_n, obs_n, mask_n = map(jnp.asarray, batch)

    q_next = masked_q(jnet.apply(target, obs_n), mask_n)
    if double:
        a_star = jnp.argmax(masked_q(jnet.apply(params, obs_n), mask_n), axis=-1)
        q_star = jnp.take_along_axis(q_next, a_star[:, None], axis=-1)[:, 0]
    else:
        q_star = jnp.max(q_next, axis=-1)
    y = reward_n + (config.gamma ** config.n_step) * (~done_n) * q_star

    def loss_fn(p):
        q = jnet.apply(p, obs)
        return jnp.mean((jnp.take_along_axis(q, action[:, None], axis=-1)[:, 0] - y) ** 2)

    jloss, grads = jax.value_and_grad(loss_fn)(params)
    opt = optax.adam(config.lr)
    updates, _ = opt.update(grads, opt.init(params), params)
    new_params = optax.apply_updates(params, updates)

    tconfig = tdqn.DQNConfig(hidden_sizes=HIDDEN, double=double)
    net = torch_qnet(params, HIDDEN, True)
    ts = tdqn.TrainState(
        net=net, target_net=torch_qnet(target, HIDDEN, True),
        opponent_net=torch_qnet(params, HIDDEN, True),
        optimizer=torch.optim.Adam(net.parameters(), lr=tconfig.lr, betas=(0.9, 0.999),
                                   eps=1e-8),
    )
    tloss = tdqn.update(tconfig, ts, tuple(map(torch.from_numpy, batch)))
    assert ts.grad_steps == 1
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    want = qnet_params_from_flax(jax.tree.map(np.asarray, new_params), True)
    for name, p in net.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-5, rtol=0,
                                   err_msg=name)
    moved = sum(float((p - q).abs().max()) for p, q in
                zip(net.state_dict().values(), qnet_params_from_flax(params, True).values()))
    assert moved > 1e-5  # the step changed the parameters


def test_target_sync_every_target_update_freq():
    config = tdqn.DQNConfig(hidden_sizes=(16,), target_update_freq=2, lr=1e-2)
    net = tmlp.QNet(hidden_sizes=(16,), dueling=True, device=CPU)
    ts = tdqn.init_train_state(config, net, torch.Generator().manual_seed(0))
    batch = tuple(map(torch.from_numpy, random_batch(32, 1)))
    tdqn.update(config, ts, batch)
    assert not torch.equal(ts.net.head.weight, ts.target_net.head.weight)
    tdqn.update(config, ts, batch)
    assert ts.grad_steps == 2
    for p, q in zip(ts.net.state_dict().values(), ts.target_net.state_dict().values()):
        assert torch.equal(p, q)


# ---------------------------------------------------------------------------
# train iteration and train()
# ---------------------------------------------------------------------------
def small_config(**kw):
    defaults = dict(buffer_size=4096, epoch=1, step_per_epoch=2, segment_len=8,
                    update_per_collect=2, batch_size=128, num_envs=64, opponent="random",
                    hidden_sizes=HIDDEN)
    defaults.update(kw)
    return tdqn.DQNConfig(**defaults)


@pytest.mark.parametrize("learner_player", [0, 1, "both"])
def test_train_iteration_runs_and_keeps_seats(learner_player):
    config = small_config(learner_player=learner_player)
    gen = torch.Generator().manual_seed(0)
    ts = tdqn.init_train_state(config, tdqn.make_net(config, CPU), gen)
    it, opp = tdqn.make_train_iteration(config)
    env_state = tdqn.init_env_state(config, opp, ts.opponent_net, gen)
    seats = tdqn.seat_array(learner_player, config.num_envs, CPU)
    assert torch.equal(env_state.current, seats)
    buf = trp.make_buffer(config.buffer_size, CPU)
    for i in range(2):
        env_state, buf, loss = it(ts, env_state, buf, gen)
        assert np.isfinite(float(loss))
        assert buf.filled == (i + 1) * config.segment_len * config.num_envs
        assert ts.grad_steps == (i + 1) * config.update_per_collect
        assert torch.equal(env_state.current, seats)  # every env at its learner's turn


def test_train_runs_and_evaluates():
    ts, history = tdqn.train(small_config(opponent="self"), generations=2, device=CPU)
    assert len(history) == 2
    assert all(np.isfinite(h["loss"]) for h in history)
    assert history[-1]["grad_steps"] == 2 * 2 * 2
    assert history[-1]["wins"] + history[-1]["losses_games"] + history[-1]["other"] > 0


@pytest.mark.parametrize("kw", [dict(opponent="greedy"), dict(opponent="mixed"),
                                dict(defense_bc_weight=1.0), dict(checkpoint="x")])
def test_unported_options_raise(kw, tmp_path):
    """The option once left unported, the defense term (``defense_bc_weight
    > 0``, A.13), now trains with every opponent and with checkpoints on:
    the bank is built, the loss stays finite and the resume points are
    written.  The solver's table is released at the end of the module."""
    kw = dict(kw)
    dirs = {}
    if kw.pop("checkpoint", None):
        dirs = dict(checkpoint_dir=str(tmp_path / "c"), full_resume_dir=str(tmp_path / "f"))
    kw.setdefault("defense_bc_weight", 0.5)
    ts, history = tdqn.train(small_config(**kw, num_envs=16, greedy_depth=1,
                                          defense_bank_games=4, defense_bank_depth=10),
                             device=CPU, **dirs)
    assert len(history) == 1 and np.isfinite(history[0]["loss"])
    assert ts.grad_steps == 2 * 2
    if dirs:
        assert ckpt.latest_step(dirs["full_resume_dir"]) == 0
        assert ckpt.latest_step(dirs["checkpoint_dir"]) == ts.grad_steps


# ---------------------------------------------------------------------------
# the feature-space Segment folds (the n-step spec)
# ---------------------------------------------------------------------------
def test_nstep_fold_terminal_rewards():
    """Hand-built segment: terminal-only rewards fold as n-step returns."""
    L, B = 6, 1
    obs = torch.zeros((L, B, 117), dtype=torch.int8)
    obs_n = torch.arange(L, dtype=torch.int8)[:, None, None] * torch.ones((L, B, 117),
                                                                          dtype=torch.int8)
    mask = torch.ones((L, B, 54), dtype=torch.bool)
    action = torch.zeros((L, B), dtype=torch.int32)
    reward = torch.tensor([0, 0, 1, 0, 0, -1], dtype=torch.float32)[:, None]
    done = torch.tensor([0, 0, 1, 0, 0, 1], dtype=torch.bool)[:, None]
    out = trp.nstep_fold(trp.Segment(obs, action, reward, done, obs_n, mask), 3, 0.9)
    np.testing.assert_allclose(out.reward[:, 0].numpy(), [0.81, 0.9, 1.0, -0.81, -0.9, -1.0],
                               atol=1e-6)
    assert out.done[:, 0].tolist() == [True] * 6
    assert out.obs_next[:, 0, 0].tolist() == [2, 2, 2, 5, 5, 5]


def random_feature_segment(S, n, B, seed):
    rng = np.random.default_rng(seed)
    L = S + n - 1
    return (rng.integers(0, 3, (L + 1, B, 117)).astype(np.int8),
            rng.random((L + 1, B, 54)) < 0.5,
            rng.integers(0, 54, (L, B)).astype(np.int32),
            rng.choice([-1.0, 0.0, 1.0], (L, B)).astype(np.float32),
            rng.random((L, B)) < 0.2)


def assert_segments_equal(tseg, jseg):
    for field, t, j in zip(jrp.Segment._fields, tseg, jseg):
        j = np.asarray(j)
        assert t.numpy().dtype == j.dtype, field
        if field == "reward":
            np.testing.assert_allclose(t.numpy(), j, atol=1e-6, rtol=0, err_msg=field)
        else:
            np.testing.assert_array_equal(t.numpy(), j, err_msg=field)


@pytest.mark.parametrize("fold", ["nstep_fold", "nstep_fold_compact"])
def test_segment_folds_match_jax(fold):
    S, n, B = 6, 3, 16
    obs, mask, action, reward, done = random_feature_segment(S, n, B, 0)
    L = S + n - 1
    if fold == "nstep_fold":
        arrays = (obs[:L], action, reward, done, obs[1:], mask[1:])
        j = jrp.nstep_fold(jrp.Segment(*map(jnp.asarray, arrays)), n, 0.9)
        t = trp.nstep_fold(trp.Segment(*map(torch.from_numpy, arrays)), n, 0.9)
    else:
        arrays = (obs, mask, action, reward, done)
        j = jrp.nstep_fold_compact(jrp.CompactSegment(*map(jnp.asarray, arrays)), n, 0.9, S)
        t = trp.nstep_fold_compact(trp.CompactSegment(*map(torch.from_numpy, arrays)), n,
                                   0.9, S)
    assert_segments_equal(t, j)


def test_nstep_fold_compact_equivalent():
    """The compact fold agrees with the full fold wherever the TD target
    looks: reward and done everywhere, the bootstrap on live rows."""
    S, n, B = 6, 3, 16
    obs, mask, action, reward, done = random_feature_segment(S, n, B, 1)
    L = S + n - 1
    old = trp.nstep_fold(trp.Segment(*map(torch.from_numpy, (
        obs[:L], action, reward, done, obs[1:], mask[1:]))), n, 0.9)
    old = trp.Segment(*(x[:S] for x in old))
    new = trp.nstep_fold_compact(trp.CompactSegment(*map(torch.from_numpy, (
        obs, mask, action, reward, done))), n, 0.9, S)
    np.testing.assert_allclose(new.reward.numpy(), old.reward.numpy(), atol=1e-6)
    assert torch.equal(new.done, old.done) and torch.equal(new.obs, old.obs)
    live = ~new.done
    assert torch.equal(new.obs_next[live], old.obs_next[live])
    assert torch.equal(new.mask_next[live], old.mask_next[live])


# ---------------------------------------------------------------------------
# greedy and mixed opponents
# ---------------------------------------------------------------------------
def test_learner_steps_with_greedy_opponent_match():
    """Learner steps against the greedy opponent, learner_player="both":
    the torch opponent gets the Gumbel fields the JAX one draws from its
    keys, so the env batches stay bit-identical, every env at its learner
    seat's turn."""
    B, steps = 64, 12
    config = jdqn.DQNConfig(opponent="greedy", greedy_depth=2, learner_player="both",
                            num_envs=B)
    tconfig = tdqn.DQNConfig(opponent="greedy", greedy_depth=2, learner_player="both",
                             num_envs=B)
    j_step = jax.jit(jdqn.make_learner_step(config, jdqn.make_opponent_fn(config, None)))
    fields = []

    def t_opp(generator, board, current, opp_net):   # the greedy, fed JAX's noise
        return greedy_jax_torch.greedy_actions(None, board, current, 2,
                                               gumbel=fields.pop(0))

    t_step = tdqn.make_learner_step(tconfig, t_opp)
    key = jax.random.PRNGKey(3)
    js = jdqn.init_env_state(config, jdqn.make_opponent_fn(config, None), None, key)
    fields.append(torch.from_numpy(np.array(jax.random.gumbel(key, (54, B)))))
    ts = tdqn.init_env_state(tconfig, t_opp, None, torch.Generator())
    seats = tdqn.seat_array("both", B, CPU)
    rng = np.random.default_rng(0)
    finished = 0
    for t in range(steps):
        mask = tbc.legal_mask_planes(ts.board, ts.current).numpy().T
        actions = np.array([rng.choice(np.nonzero(m)[0]) for m in mask], np.int32)
        key, sub = jax.random.split(key)
        k1, k2 = jax.random.split(sub)
        fields[:] = [torch.from_numpy(np.array(jax.random.gumbel(k, (54, B)))) for k in (k1, k2)]
        js, jr, jd = j_step(js, jnp.asarray(actions), sub, None)
        ts, tr, td = t_step(ts, torch.from_numpy(actions), None, None)
        for field, j, x in zip(jbc.PlanesState._fields, js, ts):
            np.testing.assert_array_equal(x.numpy(), np.asarray(j), err_msg=f"{field} at {t}")
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        assert torch.equal(ts.current, seats)
        finished += int(td.sum())
    assert finished > 0


def test_mixed_kinds_sequence_matches_jax(monkeypatch):
    """opponent="mixed" picks its iteration with the JAX trainer's numpy
    call, so the sequence of kinds is the same for a seed."""
    seqs = {"jax": [], "torch": []}

    def fake_jax(config, net, optimizer, bank=None):
        def it(ts, env_state, buffer, key):
            seqs["jax"].append(config.opponent)
            return ts, env_state, buffer, key, jnp.float32(0)
        return it, jdqn.make_opponent_fn(dataclasses_replace(config, opponent="random"), net)

    def fake_torch(config, bank=None):
        def it(ts, env_state, buffer, generator):
            seqs["torch"].append(config.opponent)
            return env_state, buffer, torch.zeros(())
        return it, tdqn.make_opponent_fn(dataclasses_replace(config, opponent="random"))

    monkeypatch.setattr(jdqn, "make_train_iteration", fake_jax)
    monkeypatch.setattr(jdqn, "make_eval_fn", lambda *a: (lambda *b: (0, 0, 0)))
    monkeypatch.setattr(tdqn, "make_train_iteration", fake_torch)
    monkeypatch.setattr(tdqn, "make_eval_fn", lambda *a: (lambda *b: (0, 0, 0)))
    kw = dict(opponent="mixed", seed=11, epoch=3, step_per_epoch=8, buffer_size=64,
              num_envs=8, hidden_sizes=(8,))
    jdqn.train(jdqn.DQNConfig(**kw))
    tdqn.train(tdqn.DQNConfig(**kw), device=CPU)
    assert len(seqs["jax"]) == 24 and set(seqs["jax"]) == {"random", "greedy", "self"}
    assert seqs["torch"] == seqs["jax"]


@pytest.mark.parametrize("opponent", ["greedy", "mixed"])
def test_greedy_and_mixed_training_runs(opponent):
    config = small_config(opponent=opponent, greedy_depth=1, step_per_epoch=4,
                          learner_player="both")
    ts, history = tdqn.train(config, generations=2, device=CPU)
    assert len(history) == 2
    assert all(np.isfinite(h["loss"]) for h in history)
    assert history[-1]["grad_steps"] == 2 * 4 * config.update_per_collect
    assert history[-1]["wins"] + history[-1]["losses_games"] + history[-1]["other"] > 0
