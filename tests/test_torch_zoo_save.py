"""Writing the zoo from the port: its msgpack writer against the committed
blobs and flax's writer (byte for byte), the reverse weight converters
against the forward ones (exactly), and ``zoo.save`` against the JAX
package's ``zoo.load`` and ``zoo.save`` (params equal; forward outputs
within 2e-2 of max |output|, the bf16 tolerance of test_torch_zoo.py;
manifest and blob bytes equal)."""

import copy
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from gobblet_rl_torch import zoo as tzoo
from gobblet_rl_torch.models import actor_critic as tac
from gobblet_rl_torch.models import convert
from gobblet_rl_torch.models.mlp import QNet as TQNet
from gobblet_rl_torch.ops import batched_core as tbc
from gobblet_rl_torch.zoo import flax_msgpack
from gobblet_rl_tpu import zoo as jzoo
from gobblet_rl_tpu.models import actor_critic as jac
from gobblet_rl_tpu.models.mlp import QNet as JQNet
from tests.torch_parity import CPU

ZOO = pathlib.Path(__file__).resolve().parents[1] / "gobblet_rl_tpu" / "zoo"
TOL = 2e-2


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
def test_writer_reproduces_committed_blob(name):
    data = (ZOO / f"{name}.msgpack").read_bytes()
    assert flax_msgpack.msgpack_serialize(flax_msgpack.msgpack_restore(data)) == data


def random_tree(rng, depth=0):
    """Nested maps (keys of 0-40 characters, in a random order) of f32,
    i32 and bool arrays of up to 3 dims, 0-d arrays and numpy scalars."""
    out = {}
    for i in rng.permutation(int(rng.integers(1, 18 if depth == 0 else 6))):
        key = f"k{i}_" + "x" * int(rng.integers(0, 40))
        kind = int(rng.integers(0, 7 if depth < 2 else 6))
        shape = tuple(int(d) for d in rng.integers(0, 6, int(rng.integers(0, 4))))
        if kind == 0:
            out[key] = rng.standard_normal(shape).astype(np.float32)
        elif kind == 1:
            out[key] = rng.integers(-2**31, 2**31, (int(rng.integers(0, 300)),)).astype(np.int32)
        elif kind == 2:
            out[key] = rng.random(shape) < 0.5
        elif kind == 3:
            out[key] = np.float32(rng.standard_normal())
        elif kind == 4:
            out[key] = np.int32(rng.integers(-2**31, 2**31))
        elif kind == 5:
            out[key] = np.asarray(rng.standard_normal(), np.float32)
        else:
            out[key] = random_tree(rng, depth + 1)
    return out


@pytest.mark.parametrize("seed", range(4))
def test_writer_equals_flax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(8):
        tree = random_tree(rng)
        # in place: flax keeps the tree's key order (a copy sorts it)
        want = serialization.msgpack_serialize(copy.deepcopy(tree), in_place=True)
        assert flax_msgpack.msgpack_serialize(tree) == want
        assert flax_msgpack.msgpack_serialize(jax.tree.map(lambda x: x, tree)) == \
            serialization.msgpack_serialize(tree)
        back = flax_msgpack.msgpack_restore(want)
        assert jax.tree.structure(back) == jax.tree.structure(tree)


@pytest.mark.parametrize("value", [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63,
                                   -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1,
                                   -2**63, 1.5, -0.0, "s" * 31, "s" * 32, "s" * 256, "s" * 65536,
                                   b"b" * 3, b"b" * 256, b"b" * 65536, [1] * 15, [1] * 16,
                                   [2**40] * 65536])
def test_writer_headers_equal_flax(value):
    tree = {"v": value, "m": {str(i): np.int8(i) for i in range(16)}}
    want = serialization.msgpack_serialize(copy.deepcopy(tree), in_place=True)
    assert flax_msgpack.msgpack_serialize(tree) == want


def test_writer_refuses_what_the_reader_refuses():
    for bad in ({"x": None}, {"x": True}, {"x": (1, 2)}, {1: 2}, {"x": np.array([object()])}):
        with pytest.raises(ValueError):
            flax_msgpack.msgpack_serialize(bad)
    with pytest.raises(ValueError):
        flax_msgpack.msgpack_serialize([1])


def fill_seeded(net, seed):
    """Every parameter of ``net`` (biases too) drawn from a seeded normal."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.from_numpy(0.2 * rng.standard_normal(tuple(p.shape)).astype(np.float32)))
    return net


def seeded_params(jnet, seed):
    params = jnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, 117), jnp.int8))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32), params)


# (flax net, torch net, to flax, from flax)
NETS = {
    "dueling_qnet": (lambda: JQNet(hidden_sizes=(32, 32), dueling=True),
                     lambda: TQNet(hidden_sizes=(32, 32), dueling=True, device=CPU),
                     lambda sd: convert.qnet_params_to_flax(sd, dueling=True),
                     lambda t: convert.qnet_params_from_flax(t, dueling=True)),
    "conv_64x2": (lambda: jac.ConvActorCritic(channels=64, blocks=2),
                  lambda: tac.ConvActorCritic(channels=64, blocks=2, device=CPU),
                  lambda sd: convert.actor_critic_params_to_flax(sd, "conv"),
                  lambda t: convert.actor_critic_params_from_flax(t, "conv")),
    "mlp_actor_critic": (lambda: jac.MLPActorCritic(hidden_sizes=(32, 32)),
                         lambda: tac.MLPActorCritic(hidden_sizes=(32, 32), device=CPU),
                         lambda sd: convert.actor_critic_params_to_flax(sd, "mlp"),
                         lambda t: convert.actor_critic_params_from_flax(t, "mlp")),
}


@pytest.mark.parametrize("kind", sorted(NETS))
def test_converters_are_exact_inverses(kind):
    make_jnet, make_tnet, to_flax, from_flax = NETS[kind]
    tree = jax.tree.map(np.asarray, seeded_params(make_jnet(), 1))
    back = to_flax(from_flax(tree))
    # names in flax's (sorted) order, shapes, dtypes and values
    assert list(back["params"]) == sorted(tree["params"])
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for (path, b), t in zip(jax.tree_util.tree_leaves_with_path(back), jax.tree.leaves(tree)):
        assert type(b) is np.ndarray and b.dtype == t.dtype and b.shape == t.shape, path
        np.testing.assert_array_equal(b, t, err_msg=str(path))
        assert b.flags.c_contiguous
    net = fill_seeded(make_tnet(), 2)
    sd = net.state_dict()
    again = from_flax(to_flax(sd))
    assert list(again) == list(sd)
    for k in sd:
        assert again[k].dtype == sd[k].dtype and torch.equal(again[k], sd[k]), k
    # the tree owns its memory: changing the module leaves it as it was
    flat = to_flax(sd)
    before = jax.tree.map(np.copy, flat)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(1.0)
    for a, b in zip(jax.tree.leaves(flat), jax.tree.leaves(before)):
        np.testing.assert_array_equal(a, b)


# zoo entries: (torch net, manifest row)
ENTRIES = {
    "dqn": (lambda: TQNet(hidden_sizes=(32, 32), dueling=True, device=CPU),
            {"family": "dqn", "net": {"hidden_sizes": [32, 32], "dueling": True}}),
    "alphazero": (lambda: tac.ConvActorCritic(channels=16, blocks=1, device=CPU),
                  {"family": "alphazero", "net": {"model": "conv", "channels": 16, "blocks": 1},
                   "eval": {"num_sims": 8}}),
    "ppo": (lambda: tac.MLPActorCritic(hidden_sizes=(32,), device=CPU),
            {"family": "ppo", "net": {"hidden_sizes": [32]}}),
}


def seeded_net(family, seed=3):
    return fill_seeded(ENTRIES[family][0](), seed)


def observations(n=64, seed=0):
    g = np.random.default_rng(seed).gumbel(size=(8, 54, n)).astype(np.float32)
    state, _ = tbc.rollout_random(tbc.reset_planes(n, CPU), None, 8, torch.from_numpy(g))
    return tbc.features_lm(state.board, state.current).t()


@pytest.mark.parametrize("family", sorted(ENTRIES))
def test_saved_entry_loads_in_jax(family, tmp_path, monkeypatch):
    monkeypatch.setenv("GOBBLET_ZOO_DIR", str(tmp_path))
    net = seeded_net(family)
    entry = {**ENTRIES[family][1], "metrics": {"vs_random": 0.5}, "recipe": "a test"}
    tzoo.save("entry", net, entry)
    assert tzoo.names() == ["entry"] and tzoo.meta("entry")["file"] == "entry.msgpack"
    jnet, jparams, jentry = jzoo.load("entry", expect_family=family)
    assert jentry == {**entry, "file": "entry.msgpack"}
    sd = net.state_dict()
    from_jax = (convert.qnet_params_from_flax(jax.tree.map(np.asarray, jparams), dueling=True)
                if family == "dqn" else
                convert.actor_critic_params_from_flax(jax.tree.map(np.asarray, jparams),
                                                      entry["net"].get("model", "mlp")))
    assert list(from_jax) == list(sd)
    for k in sd:
        assert torch.equal(from_jax[k], sd[k]), k
    obs = observations()
    with torch.no_grad():
        got = net(obs)
    want = jnet.apply(jparams, jnp.asarray(obs.numpy()))
    got = [got] if family == "dqn" else list(got)
    want = [want] if family == "dqn" else list(want)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g.float().numpy(), w, atol=TOL * np.abs(w).max(), rtol=0)
    # and back through the port's loader, weight for weight
    tnet, _, _ = tzoo.load("entry", device=CPU)
    for k, v in tnet.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_manifest_and_blob_bytes_equal_jax_save(tmp_path, monkeypatch):
    net = seeded_net("dqn")
    entry = {**ENTRIES["dqn"][1], "metrics": {"vs_random": 0.984, "train_minutes": 2.3},
             "recipe": "a test"}
    for sub in ("jax", "torch"):
        (tmp_path / sub).mkdir()
    monkeypatch.setenv("GOBBLET_ZOO_DIR", str(tmp_path / "jax"))
    params = convert.qnet_params_to_flax(net.state_dict(), dueling=True)
    jzoo.save("dqn_greedy", jax.tree.map(jnp.asarray, params), entry)
    jzoo.save("second", jax.tree.map(jnp.asarray, params), {**entry, "file": "other.msgpack"})
    monkeypatch.setenv("GOBBLET_ZOO_DIR", str(tmp_path / "torch"))
    tzoo.save("dqn_greedy", net, entry)
    tzoo.save("second", net, {**entry, "file": "other.msgpack"})
    for f in ("manifest.json", "dqn_greedy.msgpack", "other.msgpack"):
        assert (tmp_path / "torch" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    assert not list((tmp_path / "torch").glob("*.tmp"))


def test_save_refuses_the_committed_zoo(monkeypatch):
    before = {p.name: p.read_bytes() for p in ZOO.iterdir() if p.is_file()}
    net = seeded_net("ppo")
    monkeypatch.delenv("GOBBLET_ZOO_DIR", raising=False)
    with pytest.raises(RuntimeError, match="unset"):
        tzoo.save("ppo_league", net, ENTRIES["ppo"][1])
    for path in (str(ZOO), str(ZOO / ".." / "zoo"), str(ZOO) + "/"):
        monkeypatch.setenv("GOBBLET_ZOO_DIR", path)
        with pytest.raises(RuntimeError, match="committed zoo"):
            tzoo.save("ppo_league", net, ENTRIES["ppo"][1])
    assert {p.name: p.read_bytes() for p in ZOO.iterdir() if p.is_file()} == before
