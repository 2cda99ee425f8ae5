"""Port parity for the AlphaZero self-play segments: a whole segment of
the port against the JAX trainer's, on the exact float32 net of
``torch_parity.py`` (both frameworks compute its logits bit for bit).

* Gumbel (``search="gumbel_lm"``): the root noise zeroed on both sides (as
  tests/test_gumbel_lm.py:52 zeroes it), and JAX's own per-ply fields
  rebuilt from its key chain and fed to the port.
* PUCT: ``dirichlet_alpha=0`` and ``temp_moves=0``, so no draw is left.

Observations, masks, players, done flags, winners and the final env batch
must be identical; the policy targets and the bootstrap values agree within
1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gobblet_rl_torch.ops import batched_core as tbc
from gobblet_rl_torch.train import alphazero as taz
from gobblet_rl_tpu.ops import batched_core as jbc
from gobblet_rl_tpu.train import alphazero as jaz
from tests.torch_parity import CPU, exact_nets, t

B, L = 8, 12


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes on a few cores, where torch's thread pools would oversubscribe
    them and small ops slow down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def config(search, **kw):
    base = dict(num_envs=B, num_sims=10, segment_len=L, search=search, max_considered=8,
                model="mlp", hidden_sizes=(64,), dirichlet_alpha=0.0, temp_moves=0)
    base.update(kw)
    return base


def assert_segments_equal(jout, tout):
    (jstate, jtraj), (tstate, ttraj) = jout, tout
    assert jtraj.keys() == ttraj.keys()
    for k in jtraj:
        want, got = np.asarray(jtraj[k]), ttraj[k].numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, k
        if k in ("pi", "v_signed"):
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)
    for name, x, y in zip(jbc.PlanesState._fields, jstate, tstate):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x), err_msg=name)
    done, winner = ttraj["done"].numpy(), ttraj["winner"].numpy()
    assert done.any() and (winner[done] != 0).all()


@pytest.mark.parametrize("noise", ["zero", "jax_keys"])
def test_gumbel_segment_equals_jax(noise, monkeypatch):
    jnet, params, tnet = exact_nets()
    key = jax.random.PRNGKey(5)
    if noise == "zero":
        monkeypatch.setattr(jax.random, "gumbel",
                            lambda key, shape=(), dtype=jnp.float32: jnp.zeros(shape, dtype))
        fields = torch.zeros(L, 54, B)
    else:
        # the segment splits (key, k_search) each ply; the search draws
        # gumbel(k_search, (54, B))
        fields, k = [], key
        for _ in range(L):
            k, k_search = jax.random.split(k)
            fields.append(np.asarray(jax.random.gumbel(k_search, (54, B), jnp.float32)))
        fields = t(np.stack(fields))
    jout = jax.jit(jaz.make_selfplay_segment(jaz.AZConfig(**config("gumbel_lm")), jnet))(
        params, jbc.reset_planes(B), key)
    tseg = taz.make_selfplay_segment(taz.AZConfig(**config("gumbel_lm")))
    tout = tseg(tnet, tbc.reset_planes(B, CPU), None, noise=fields)
    assert_segments_equal(jout, tout)


def test_puct_segment_equals_jax():
    jnet, params, tnet = exact_nets(seed=1)
    jout = jax.jit(jaz.make_selfplay_segment(jaz.AZConfig(**config("puct")), jnet))(
        params, jbc.reset_planes(B), jax.random.PRNGKey(6))
    tseg = taz.make_selfplay_segment(taz.AZConfig(**config("puct")))
    tout = tseg(tnet, tbc.reset_planes(B, CPU), torch.Generator().manual_seed(0))
    assert_segments_equal(jout, tout)


def test_puct_segment_with_noise_and_temperature_targets_are_consistent():
    """With root noise and visit sampling on (draws from the generator),
    the targets stay distributions over the legal actions and every
    finished game has a winner (tests/test_alphazero.py:58)."""
    cfg = taz.AZConfig(**config("puct", dirichlet_alpha=0.5, temp_moves=4, segment_len=16))
    _, _, tnet = exact_nets()
    _, traj = taz.make_selfplay_segment(cfg)(tnet, tbc.reset_planes(B, CPU),
                                             torch.Generator().manual_seed(1))
    pi, mask = traj["pi"].numpy(), traj["mask"].numpy()
    assert (pi >= 0).all() and (pi[~mask] == 0).all()
    np.testing.assert_allclose(pi.sum(-1), 1.0, atol=1e-5)
    done, winner = traj["done"].numpy(), traj["winner"].numpy()
    assert done.any() and (winner[done] != 0).all()
