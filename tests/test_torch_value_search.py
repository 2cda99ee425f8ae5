"""The torch port's learned-eval value search (policies/value_search.py)
against the JAX package's, on the CPU.

Both searches run over exact float32 nets (weights multiples of 2^-6, one
hidden layer: every dot product is exact) on 64 random positions 10 plies
deep, with JAX's tie field rebuilt from its key and injected into the
port (``gumbel=``).  The DQN head's max legal Q is then bit-identical, so
the actions must be too (tolerance 0).  The actor-critic's ``tanh`` may
differ by an ulp between the frameworks: leaf values are held within
1e-6, and actions equal wherever the two best noisy scores differ by more
than 1e-6 (``tests/test_torch_value_search_az.py``).  The search chunks
its candidate axis; a chunk of 7 candidates gives the unchunked scores and
actions.  The zoo's value heads (a dueling ``QNet``, whose mean over 54
actions is not exact in float32, and bf16 nets) agree with JAX's within
bf16 tolerance only: 2e-2 of the largest value, as
``tests/test_torch_zoo.py`` holds their outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gobblet_rl_torch import zoo as tzoo
from gobblet_rl_torch.ops import batched_core as tbc
from gobblet_rl_torch.policies import value_search as tvs
from gobblet_rl_tpu import zoo as jzoo
from gobblet_rl_tpu.policies import value_search as jvs
from tests.torch_parity import exact_nets, exact_qnets, positions, t

B, PLIES = 64, 10
CASES = [(1, True), (2, False), (2, True)]


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
def nets():
    jq, qparams, tq = exact_qnets()
    jac, acparams, tac = exact_nets()
    return {"dqn": (jvs.dqn_value_fn(jq, qparams), tvs.dqn_value_fn(tq)),
            "az": (jvs.az_value_fn(jac, acparams), tvs.az_value_fn(tac))}


@pytest.fixture(scope="module")
def inputs():
    board, cur = positions(B, PLIES, 3)
    key = jax.random.PRNGKey(11)
    field = np.asarray(jax.random.gumbel(key, (54, B), jnp.float32))
    return board, cur, key, field


def run_both(nets, inputs, head, depth, solve):
    board, cur, key, field = inputs
    jvf, tvf = nets[head]
    jpol = jvs.make_value_search(jvf, depth=depth, solve_leaves=solve)
    want = np.asarray(jpol(key, jnp.asarray(board), jnp.asarray(cur)))
    tpol = tvs.make_value_search(tvf, depth=depth, solve_leaves=solve)
    got = tpol(None, t(board), t(cur), gumbel=t(field))
    assert got.dtype == torch.int32
    return want, got.numpy()


@pytest.mark.parametrize("depth,solve", CASES)
def test_dqn_search_actions_equal_jax(nets, inputs, depth, solve):
    want, got = run_both(nets, inputs, "dqn", depth, solve)
    np.testing.assert_array_equal(got, want)


def test_fold_and_can_win_equal_jax(inputs):
    board, cur, _, _ = inputs
    got = tvs._fold_actions(t(board), t(cur)).numpy()
    want = np.asarray(jax.jit(jvs._fold_actions)(jnp.asarray(board), jnp.asarray(cur)))
    np.testing.assert_array_equal(got, want)
    them = np.tile(1 - cur, 54).astype(np.int32)
    got = tvs._can_win_now(torch.from_numpy(got), torch.from_numpy(them)).numpy()
    want = np.asarray(jax.jit(jvs._can_win_now)(jnp.asarray(want), jnp.asarray(them)))
    np.testing.assert_array_equal(got, want)
    assert 0 < got.mean() < 1


@pytest.mark.parametrize("depth,solve", CASES)
def test_chunked_search_equals_unchunked(nets, inputs, monkeypatch, depth, solve):
    """Seven candidates a chunk (eight chunks, the last of five) give the
    scores and the actions of one chunk of all 54."""
    board, cur, _, field = inputs
    b, c, g = t(board[..., :16]), t(cur[:16]), t(field[:, :16])
    whole = tvs.search_scores(nets["az"][1], b, c, depth, solve)
    assert tvs.candidate_chunk(16, depth, solve) == 54
    per_candidate = 16 * (54 if depth == 2 else 1) * (54 if depth == 2 and solve else 1)
    monkeypatch.setattr(tvs, "FOLD_LANES", 7 * per_candidate)
    monkeypatch.setattr(tvs, "NET_LANES", 7 * per_candidate)
    assert tvs.candidate_chunk(16, depth, solve) == 7
    chunked = tvs.search_scores(nets["az"][1], b, c, depth, solve)
    assert torch.equal(chunked, whole)
    pol = tvs.make_value_search(nets["az"][1], depth=depth, solve_leaves=solve)
    actions = pol(None, b, c, gumbel=g)
    monkeypatch.undo()
    assert torch.equal(actions, pol(None, b, c, gumbel=g))


def test_value_search_draws_from_the_generator(nets, inputs):
    """Without a field the tie noise is ``gumbel_field`` of the generator."""
    board, cur, _, _ = inputs
    pol = tvs.make_value_search(nets["dqn"][1], depth=1)
    a = pol(torch.Generator().manual_seed(5), t(board), t(cur))
    field = tbc.gumbel_field(torch.Generator().manual_seed(5), (54, B), torch.device("cpu"))
    assert torch.equal(a, pol(None, t(board), t(cur), gumbel=field))
    with pytest.raises(ValueError):
        pol(None, t(board), t(cur))


@pytest.mark.parametrize("name", ["dqn_greedy", "alphazero_gumbel32", "ppo_league"])
def test_zoo_value_fns_within_bf16_tolerance(name):
    """Each zoo entry's leaf evaluator on every depth-1 child of 32
    positions (1,728 boards), the port's against JAX's."""
    board, cur = positions(32, 8, 2)
    b, c = torch.from_numpy(board), torch.from_numpy(cur)
    children = tvs._fold_actions(b, c)
    them = (1 - c).repeat(54)
    jnet, params, entry = jzoo.load(name)
    jvf = jvs.dqn_value_fn(jnet, params) if entry["family"] == "dqn" else \
        jvs.az_value_fn(jnet, params)
    net, _, _ = tzoo.load(name, device=torch.device("cpu"))
    tvf = tvs.dqn_value_fn(net) if entry["family"] == "dqn" else tvs.az_value_fn(net)
    want = np.asarray(jvf(jnp.asarray(children.numpy()), jnp.asarray(them.numpy())))
    got = tvf(children, them).numpy()
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    tol = 2e-2 * float(np.abs(want[finite]).max())
    assert float(np.abs(got[finite] - want[finite]).max()) <= tol
