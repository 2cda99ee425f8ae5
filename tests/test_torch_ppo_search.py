"""Port parity for PPO's collect segment against the "search" opponent
(the zoo's AlphaZero net behind the lane-major Gumbel search): both
packages' ``zoo.load`` return the exact float32 net of ``torch_parity.py``,
and the search's root Gumbel fields come from JAX's key chain (the
template and tolerances of test_torch_ppo_rollout.py).  Also the league's
"search" leg end to end in ``train``.
"""

import numpy as np
import pytest
import torch

from gobblet_rl_torch import zoo as tzoo
from gobblet_rl_torch.train import ppo as tppo
from gobblet_rl_tpu import zoo as jzoo
from tests.test_torch_ppo_rollout import B, assert_rollouts_equal, run_both
from tests.torch_parity import CPU, exact_nets

SIMS = 4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes on a few cores, where torch's thread pools would oversubscribe
    them and small ops slow down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def exact_zoo(monkeypatch):
    """Both zoos' loaders hand out the exact net (seed 2) as the AlphaZero
    entry."""
    jnet, params, tnet = exact_nets(seed=2)
    meta = {"family": "alphazero"}
    monkeypatch.setattr(jzoo, "load", lambda name, expect_family=None: (jnet, params, meta))
    monkeypatch.setattr(tzoo, "load",
                        lambda name, expect_family=None, device=None: (tnet, None, meta))


@pytest.mark.parametrize("lp", [0, 1, "both"])
def test_rollout_against_search_equals_jax(lp, exact_zoo):
    jnet, params, tnet = exact_nets()
    jout, tout = run_both("search", lp, jnet, params, tnet, (params, tnet), seed=1,
                          search_sims=SIMS)
    assert_rollouts_equal(jout, tout)
    assert tout[1]["done"].numpy().any()
    assert torch.equal(tout[0].current, tppo.seat_array(lp, B, CPU))


def test_search_leg_trains():
    """The "search" opponent and the 4-weight league drawing it, on the
    committed zoo entry (tests/test_ppo.py:54,72)."""
    cfg = dict(shared_policy=True, learner_player="both", search_sims=2, num_envs=8,
               segment_len=6, minibatches=2, epochs_per_iter=1, hidden_sizes=(16,))
    _, history = tppo.train(tppo.PPOConfig(opponent="search", iterations=2, **cfg), device=CPU)
    assert [h["opponent"] for h in history] == ["search", "search"]
    assert all(np.isfinite(h["loss"]) for h in history)
    _, history = tppo.train(tppo.PPOConfig(opponent="mixed", mixed_weights=(0.0, 0.0, 0.0, 1.0),
                                           iterations=1, **cfg), device=CPU)
    assert history[0]["opponent"] == "search"
