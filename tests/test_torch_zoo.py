"""The torch zoo loader: its msgpack reader against flax's, leaf for leaf,
on every committed blob; ``dqn_greedy``'s Q-values and
``alphazero_gumbel32``'s logits and values against the JAX zoo's (bf16
tolerance: 2e-2 of max |output|, as in test_torch_dqn.py); their
policies; ``ppo_league``'s logits and values against JAX's and its
policy; the loader's refusals; ``GOBBLET_ZOO_DIR``."""

import json
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from gobblet_rl_torch import zoo as tzoo
from gobblet_rl_torch.eval import tournament
from gobblet_rl_torch.models import actor_critic as tac
from gobblet_rl_torch.ops import batched_core as tbc
from gobblet_rl_torch.zoo import flax_msgpack
from gobblet_rl_tpu import zoo as jzoo

CPU = torch.device("cpu")
ZOO = pathlib.Path(__file__).resolve().parents[1] / "gobblet_rl_tpu" / "zoo"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes on a few cores, where torch's thread pools would oversubscribe
    them and small ops slow down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", ["dqn_greedy", "alphazero_gumbel32", "ppo_league"])
def test_reader_equals_flax(name):
    data = (ZOO / f"{name}.msgpack").read_bytes()
    got, want = flax_msgpack.msgpack_restore(data), serialization.msgpack_restore(data)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(want)):
        assert type(g) is type(w) and g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))


def test_reader_scalars_and_errors():
    import msgpack

    tree = {"a": np.float32(1.5), "b": {"c": np.arange(6, dtype=np.int16).reshape(2, 3)},
            "d": 7, "e": -3, "f": 2.25, "g": "text", "h": [1, 300, 70000, 2**40]}
    data = serialization.msgpack_serialize(tree)
    got = flax_msgpack.msgpack_restore(data)
    want = serialization.msgpack_restore(data)
    assert got.keys() == want.keys()
    assert type(got["a"]) is np.float32 and got["a"] == want["a"]
    np.testing.assert_array_equal(got["b"]["c"], want["b"]["c"])
    assert [got[k] for k in "defgh"] == [want[k] for k in "defgh"]
    with pytest.raises(ValueError, match="type byte"):
        flax_msgpack.msgpack_restore(msgpack.packb({"x": None}))
    with pytest.raises(ValueError, match="extension type"):
        flax_msgpack.msgpack_restore(msgpack.packb({"x": msgpack.ExtType(2, b"ab")}))
    with pytest.raises(ValueError):
        flax_msgpack.msgpack_restore(data[:-3])


def fixed_positions(n=512, seed=0):
    g = np.random.default_rng(seed).gumbel(size=(10, 54, n)).astype(np.float32)
    state, _ = tbc.rollout_random(tbc.reset_planes(n, CPU), None, 10, torch.from_numpy(g))
    return state.board, state.current


def test_dqn_greedy_q_values_match_jax():
    board, cur = fixed_positions()
    obs = tbc.features_lm(board, cur).t()
    net, params, entry = tzoo.load("dqn_greedy", expect_family="dqn", device=CPU)
    assert entry["family"] == "dqn"
    with torch.no_grad():
        got = net(obs).numpy()
    jnet, jparams, _ = jzoo.load("dqn_greedy")
    want = np.asarray(jnet.apply(jparams, jnp.asarray(obs.numpy())))
    tol = 2e-2 * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    mask = tbc.legal_mask_planes(board, cur).t().numpy()
    masked = np.where(mask, want, -np.inf)
    top2 = np.sort(masked, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * tol
    assert clear.sum() > 128
    np.testing.assert_array_equal(np.where(mask, got, -np.inf).argmax(1)[clear],
                                  masked.argmax(1)[clear])
    # the flax tree came back as numpy arrays, leaf for leaf
    for g, w in zip(jax.tree.leaves(params), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_policy_plays_legal_moves():
    pol = tzoo.policy("dqn_greedy", device=CPU)
    gen = torch.Generator().manual_seed(0)
    state = tbc.reset_planes(64, CPU)
    for _ in range(20):
        mask = tbc.legal_mask_planes(state.board, state.current)
        a = pol(gen, state.board, state.current)
        assert mask[a.long(), torch.arange(64)].all()
        state = tbc.autoreset_planes(tbc.step_planes(state, a))
    m = tournament.play_match(pol, tournament.random_policy(), num_games=64, device=CPU)
    assert m["win_rate"] > 0.8, m


def test_alphazero_gumbel32_matches_jax():
    board, cur = fixed_positions()
    obs = tbc.features_lm(board, cur).t()
    net, _, entry = tzoo.load("alphazero_gumbel32", expect_family="alphazero", device=CPU)
    assert entry["eval"] == {"num_sims": 128} and net.dtype == torch.bfloat16
    with torch.no_grad():
        got = [x.numpy() for x in net(obs)]
    jnet, jparams, _ = jzoo.load("alphazero_gumbel32")
    want = [np.asarray(x) for x in jnet.apply(jparams, jnp.asarray(obs.numpy()))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=2e-2 * np.abs(w).max(), rtol=0)
    tol = 2e-2 * np.abs(want[0]).max()
    mask = tbc.legal_mask_planes(board, cur).t().numpy()
    masked = np.where(mask, want[0], -np.inf)
    top2 = np.sort(masked, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * tol
    assert clear.sum() > 128
    np.testing.assert_array_equal(np.where(mask, got[0], -np.inf).argmax(1)[clear],
                                  masked.argmax(1)[clear])
    with pytest.raises(ValueError, match="expects 'dqn'"):
        tzoo.load("alphazero_gumbel32", expect_family="dqn", device=CPU)


def test_alphazero_policy_plays_legal_moves():
    pol = tzoo.policy("alphazero_gumbel32", device=CPU, num_sims=16)
    state = tbc.reset_planes(32, CPU)
    for _ in range(6):
        mask = tbc.legal_mask_planes(state.board, state.current)
        a = pol(None, state.board, state.current)
        assert a.dtype == torch.int32 and mask[a.long(), torch.arange(32)].all()
        state = tbc.autoreset_planes(tbc.step_planes(state, a))


def test_ppo_league_matches_jax():
    """Logits and values within the bf16 tolerance of the JAX zoo's; the
    masked argmax equal wherever the top two logits are separated."""
    board, cur = fixed_positions()
    obs = tbc.features_lm(board, cur).t()
    net, _, entry = tzoo.load("ppo_league", device=CPU)
    assert entry["family"] == "ppo" and net.dtype == torch.bfloat16
    with torch.no_grad():
        got = [x.numpy() for x in net(obs)]
    jnet, jparams, _ = jzoo.load("ppo_league")
    want = [np.asarray(x) for x in jnet.apply(jparams, jnp.asarray(obs.numpy()))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=2e-2 * np.abs(w).max(), rtol=0)
    tol = 2e-2 * np.abs(want[0]).max()
    mask = tbc.legal_mask_planes(board, cur).t().numpy()
    masked = np.where(mask, want[0], -np.inf)
    top2 = np.sort(masked, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * tol
    assert clear.sum() > 128
    np.testing.assert_array_equal(np.where(mask, got[0], -np.inf).argmax(1)[clear],
                                  masked.argmax(1)[clear])


def test_ppo_league_policy_beats_random():
    pol = tzoo.policy("ppo_league", device=CPU)
    state = tbc.reset_planes(32, CPU)
    for _ in range(8):
        a = pol(None, state.board, state.current)
        assert a.dtype == torch.int32
        assert tbc.legal_mask_planes(state.board, state.current)[a.long(), torch.arange(32)].all()
        state = tbc.autoreset_planes(tbc.step_planes(state, a))
    m = tournament.play_match(tzoo.policy("ppo_league", device=CPU, sample=True),
                              tournament.random_policy(), num_games=64, device=CPU)
    assert m["win_rate"] > 0.8, m


@pytest.mark.parametrize("name,needs", [("ppo_league", "A.12")])
def test_other_families_raise(name, needs, tmp_path, monkeypatch):
    """``ppo_league``'s family, which waited for A.12, now loads; what
    raises is an entry of another family than expected, a family the
    loader does not know, and an unknown name."""
    net, _, entry = tzoo.load(name, expect_family="ppo", device=CPU)
    assert entry["family"] == "ppo" and isinstance(net, tac.MLPActorCritic)
    with pytest.raises(ValueError, match="expects 'dqn'"):
        tzoo.load(name, expect_family="dqn", device=CPU)
    manifest = json.loads((ZOO / "manifest.json").read_text())
    shutil.copy(ZOO / manifest[name]["file"], tmp_path / manifest[name]["file"])
    (tmp_path / "manifest.json").write_text(json.dumps({name: dict(manifest[name],
                                                                   family="sarsa")}))
    monkeypatch.setenv("GOBBLET_ZOO_DIR", str(tmp_path))
    with pytest.raises(ValueError, match="unknown zoo family 'sarsa'"):
        tzoo.load(name, device=CPU)
    with pytest.raises(KeyError):
        tzoo.meta("no_such_agent")


def test_zoo_dir_env_is_honoured(tmp_path, monkeypatch):
    manifest = json.loads((ZOO / "manifest.json").read_text())
    entry = dict(manifest["dqn_greedy"], file="copy.msgpack")
    shutil.copy(ZOO / "dqn_greedy.msgpack", tmp_path / "copy.msgpack")
    (tmp_path / "manifest.json").write_text(json.dumps({"my_agent": entry}))
    assert "dqn_greedy" in tzoo.names()
    monkeypatch.setenv("GOBBLET_ZOO_DIR", str(tmp_path))
    assert tzoo.names() == ["my_agent"]
    net, _, _ = tzoo.load("my_agent", device=CPU)
    monkeypatch.delenv("GOBBLET_ZOO_DIR")
    ref, _, _ = tzoo.load("dqn_greedy", device=CPU)
    for x, y in zip(net.state_dict().values(), ref.state_dict().values()):
        assert torch.equal(x, y)
