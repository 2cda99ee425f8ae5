"""The collective audit of the port (``gobblet_rl_torch/parallel/
collective_audit.py``), the twin of tests/test_sharding.py:254-414, on two
gloo ranks that import no JAX (``tests/torch_ranks.py``).

The census of one data-parallel iteration of each family holds only
all-reduces, whose bytes add up to at most ``updates x (param bytes +
4096)`` (PPO's moment pair and the scalar stats fit in the slack); the
env and ring leaves are each rank's 1/N block.  Two regressions make the
audit fail: the ring kept whole on every rank, and an env leaf kept whole
(which also breaks the iteration, as JAX's build breaks)."""

import pytest
import torch

from gobblet_rl_torch.parallel import collective_audit as ca
from gobblet_rl_torch.parallel.multihost import spawn_ranks
from tests import torch_ranks

N = 2
DQN = dict(num_envs=64, buffer_size=2048, batch_size=64, segment_len=4, update_per_collect=2,
           opponent="random", hidden_sizes=(32, 32))
AZ = dict(num_envs=16, num_sims=4, segment_len=4, temp_moves=2, batch_size=16,
          updates_per_iter=2, model="mlp", hidden_sizes=(16,))
PPO = dict(num_envs=32, segment_len=8, minibatches=2, epochs_per_iter=2, hidden_sizes=(32, 32),
           model="mlp")
ENV = {"board": (3, 9), "current": (), "turn": (), "done": (), "winner": (), "last_action": (),
       "rewards": (2,)}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes on a few cores, where torch's thread pools would oversubscribe
    them and small ops slow down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def audits():
    return spawn_ranks(torch_ranks.audit_rank, N, (DQN, AZ, PPO), device="cpu", timeout=180)


def env_partitioned(leaves: dict, num_envs: int) -> bool:
    return all(ca.is_partitioned(shape, (*ENV[name.split(".")[-1]], num_envs), N)
               for name, shape in leaves.items())


@pytest.mark.parametrize("family,num_envs", [("dqn", 64), ("az", 16), ("ppo", 32)])
def test_dp_iteration_census_and_layout(audits, family, num_envs):
    for res in audits:
        audit = res[family]
        census = audit["census"]
        assert census and {c["op"] for c in census} == {"all_reduce"}, census
        total = sum(c["bytes"] for c in census)
        assert audit["param_bytes"] < total <= audit["updates"] * (audit["param_bytes"] + 4096)
        # one parameter-sized bucket an update, nothing batch-sized
        assert sum(c["bytes"] >= audit["param_bytes"] for c in census) == audit["updates"]
        assert set(audit["env"]) >= {"board", "current"}
        assert env_partitioned(audit["env"], num_envs), audit["env"]


def test_ring_is_partitioned(audits):
    for res in audits:
        ring = res["dqn"]["ring"]
        assert ring["board"] == (DQN["buffer_size"] // N, 27)
        assert all(ca.is_partitioned(shape, (DQN["buffer_size"], *shape[1:]), N)
                   for shape in ring.values())


def test_audit_catches_a_whole_ring_or_env_leaf(audits):
    for res in audits:
        ring = res["whole_ring"]
        assert ring["board"] == (DQN["buffer_size"], 27)   # the full ring on every rank
        assert not ca.is_partitioned(ring["board"], (DQN["buffer_size"], 27), N)
        env = res["whole_board"]
        assert not env_partitioned(env, DQN["num_envs"])
        assert env_partitioned({k: v for k, v in env.items() if k != "board"}, DQN["num_envs"])
        assert not res["whole_board_runs"]


def test_is_partitioned_and_local_leaves():
    assert ca.is_partitioned((3, 9, 8), (3, 9, 16), 2)
    assert not ca.is_partitioned((3, 9, 16), (3, 9, 16), 2)   # replicated
    assert not ca.is_partitioned((3, 9, 4), (3, 9, 16), 2)    # a quarter, not a half
    assert not ca.is_partitioned((8,), (8,), 1)
    assert ca.local_leaves({"a": torch.zeros(2, 3), "b": {"c": torch.zeros(4)}, "n": 5}) == {
        "a": (2, 3), "b.c": (4,)}
