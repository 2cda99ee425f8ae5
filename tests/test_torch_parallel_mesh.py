"""Port parity for ``gobblet_rl_torch/parallel/mesh.py`` (the twin of
tests/test_multihost.py:52-64 and of the mesh placement of
tests/test_sharding.py): the no-op bootstrap, a bindable free port, the
mesh's shape, names and refusals, and each rank's block of a sharded env
state against JAX's ``addressable_shards`` on the virtual CPU mesh (exact:
integer state).  Torch ranks are spawned gloo processes that import no
JAX (``tests/torch_ranks.py``)."""

import socket

import jax
import numpy as np
import pytest
import torch

from gobblet_rl_torch.parallel import mesh as tmesh
from gobblet_rl_torch.parallel.multihost import pick_free_port, spawn_ranks
from gobblet_rl_tpu.ops import batched_core as jbc
from gobblet_rl_tpu.parallel import mesh as jmesh
from tests import torch_ranks


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes on a few cores, where torch's thread pools would oversubscribe
    them and small ops slow down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_init_distributed_noop_without_coordinator():
    """No coordinator: no process group, no device touched."""
    assert tmesh.init_distributed() is None
    assert not torch.distributed.is_initialized()


def test_pick_free_port_is_bindable():
    port = pick_free_port()
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", port))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.init_distributed("localhost:1", 1, 0)


def test_rank_generators_differ_and_rank0_is_the_seed():
    draws = [torch.rand(4, generator=tmesh.rank_generator(7, r, "cpu")) for r in range(3)]
    assert torch.equal(draws[0], torch.rand(4, generator=torch.Generator().manual_seed(7)))
    assert not torch.equal(draws[0], draws[1]) and not torch.equal(draws[1], draws[2])


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_and_env_blocks_equal_jax(n):
    B = 16
    state, _, _ = jbc.rollout_random(jbc.reset_planes(B), jax.random.PRNGKey(n), 7)
    jstate = jmesh.shard_env_state(state, jmesh.make_mesh(n))
    results = spawn_ranks(torch_ranks.mesh_rank, n, (tuple(np.asarray(x) for x in state),),
                          device="cpu", timeout=120)
    for r, res in enumerate(results):
        assert res["no_jax"]
        assert res["shape"] == (n, 1) and res["names"] == ("env", "model")
        assert res["shape_mp2"] == (n // 2, 2) and res["env_index_mp2"] == r // 2
        assert res["refused"] == ["AssertionError", "ValueError"]
        for name, leaf, got in zip(jbc.PlanesState._fields, jstate, res["block"]):
            want = np.asarray(leaf.addressable_shards[r].data)
            assert got.shape[-1] == B // n, name
            np.testing.assert_array_equal(got, want, err_msg=f"{name} on rank {r}")
