"""The torch port's value search over an actor-critic's value head
(``az_value_fn``) against the JAX package's, on the CPU: exact float32
nets, 64 random positions, JAX's tie field injected (see
``tests/test_torch_value_search.py``).  ``tanh`` may differ by an ulp
between the frameworks, so leaf values are held within 1e-6 and actions
equal wherever the two best noisy scores differ by more than 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gobblet_rl_torch.policies import value_search as tvs
from gobblet_rl_tpu.policies import value_search as jvs
from tests.test_torch_value_search import CASES, inputs, one_torch_thread, run_both  # noqa: F401
from tests.torch_parity import exact_nets, t


@pytest.fixture(scope="module")
def nets():
    jac, acparams, tac = exact_nets()
    return {"az": (jvs.az_value_fn(jac, acparams), tvs.az_value_fn(tac))}


@pytest.mark.parametrize("depth,solve", CASES)
def test_az_search_actions_equal_jax(nets, inputs, depth, solve):
    """Actions equal wherever the two best noisy scores are more than 1e-6
    apart (the port's scores), which must be most positions."""
    board, cur, _, field = inputs
    want, got = run_both(nets, inputs, "az", depth, solve)
    score = tvs.search_scores(nets["az"][1], t(board), t(cur), depth, solve)
    top2 = (score + 1e-5 * t(field)).topk(2, dim=0).values
    clear = (top2[0] - top2[1] > 1e-6).numpy()
    assert clear.mean() >= 0.9, clear.mean()
    np.testing.assert_array_equal(got[clear], want[clear])


def test_az_leaf_values_within_1e6(nets, inputs):
    """The actor-critic leaf evaluator on every depth-2 leaf of 4 positions
    (11,664 boards, legal or not), JAX's against the port's."""
    board, cur, _, _ = inputs
    b, c = t(board[..., :4]), t(cur[:4])
    boards1 = tvs._fold_actions(b, c)
    leaves = tvs._fold_actions(boards1, (1 - c).repeat(54))
    us = c.repeat(54 * 54)
    got = nets["az"][1](leaves, us).numpy()
    want = np.asarray(nets["az"][0](jnp.asarray(leaves.numpy()), jnp.asarray(us.numpy())))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
