"""``defense_audit`` of the committed ``ppo_league`` (bf16 nets in both
packages) against the JAX package's, under an oracle of fixed salt at the
audit's depth 18: the same dict (tolerance 0).  Both libraries' solver
tables are cleared first, so the oracle picks the same attack line in
both; they are released at the end of the module.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gobblet_rl_torch import zoo as tzoo
from gobblet_rl_torch.eval import tournament as ttour
from gobblet_rl_torch.native import engine as tengine
from gobblet_rl_tpu import zoo as jzoo
from gobblet_rl_tpu.eval import tournament as jtour
from gobblet_rl_tpu.native import engine as jengine
from tests.torch_parity import CPU

DEPTH, GAMES, SALT = 18, 8, 3


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


def test_ppo_league_audit_equals_jax():
    def oracle(engine, lane_major):
        def fn(_, board, current):
            boards = np.asarray(board).transpose(2, 0, 1).reshape(-1, 27)
            return lane_major(engine.solve_batch(boards, np.asarray(current, np.int32), DEPTH,
                                                 SALT))
        return fn

    jengine.load()
    tengine.solve_tt_clear()
    jengine.solve_tt_clear()
    want = jtour.defense_audit(jzoo.policy("ppo_league"), num_games=GAMES, depth=DEPTH,
                               oracle_policy=oracle(jengine, jnp.asarray))
    got = ttour.defense_audit(tzoo.policy("ppo_league", device=CPU), num_games=GAMES,
                              depth=DEPTH, oracle_policy=oracle(tengine, torch.from_numpy),
                              device=CPU)
    assert got == want
    assert got["ungraded_games"] == 0 and got["mistakes_per_game"] > 0
