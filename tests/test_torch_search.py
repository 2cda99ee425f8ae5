"""Port parity for the Gumbel searches: the lane-major search, its
batch-first entry point and their primitives, gobblet_rl_torch against
gobblet_rl_tpu on the CPU.

The net on both sides is the exact float32 MLP of ``torch_parity.py``:
both frameworks compute the same logits bit for bit, and only the
``exp``/``log``/``tanh`` of the softmax and the value head can differ by an
ulp.  Under one shared noise field the searches must then give identical
actions and visit counts on every root; the improved policy, root values
and visited Q-values agree within 1e-6 (the float sums of the mixed value
run in different orders).  The tactical cases replay JAX's own
(tests/test_gumbel_lm.py): its bfloat16 net, converted, and its noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gobblet_rl_torch.models import actor_critic as tac
from gobblet_rl_torch.models.convert import actor_critic_params_from_flax
from gobblet_rl_torch.ops import batched_core as tbc
from gobblet_rl_torch.search import gumbel as tgumbel
from gobblet_rl_torch.search import gumbel_lm as tglm
from gobblet_rl_torch.search import mcts as tmcts
from gobblet_rl_torch.search import mcts_lm as tmlm
from gobblet_rl_tpu.core import rules_np
from gobblet_rl_tpu.models import actor_critic as jac
from gobblet_rl_tpu.search import gumbel as jgumbel
from gobblet_rl_tpu.search import gumbel_lm as jglm
from tests.torch_parity import CPU, exact_nets, japply, positions, t

GCFG = jgumbel.GumbelConfig(num_sims=12, max_considered=8)
TGCFG = tgumbel.GumbelConfig(num_sims=12, max_considered=8)


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
    return exact_nets()


def assert_tree_outputs(got, want):
    """Gumbel outputs (actions, pi, q, visits, root_value)."""
    a1, pi1, q1, v1, rv1 = (np.asarray(x) for x in want)
    a2, pi2, q2, v2, rv2 = (x.numpy() for x in got)
    np.testing.assert_array_equal(a2, a1)
    np.testing.assert_array_equal(v2, v1)
    np.testing.assert_allclose(pi2, pi1, atol=1e-6, rtol=0)
    np.testing.assert_allclose(rv2, rv1, atol=1e-6, rtol=0)
    vis = v1 > 0
    np.testing.assert_allclose(q2[vis], q1[vis], atol=1e-6, rtol=0)
    assert (q2[~vis] == -np.inf).all()


# ---------------------------------------------------------------------------
# primitives and host tables
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("num_sims,m", [(12, 8), (32, 16), (128, 16), (5, 1), (3, 64)])
def test_phase_tables_equal_jax(num_sims, m):
    ph = tgumbel._phase_table(num_sims, m)
    np.testing.assert_array_equal(ph, jgumbel._phase_table(num_sims, m))
    assert ph.dtype == np.int32
    np.testing.assert_array_equal(tgumbel._considered_counts(m, int(ph[-1]) + 1),
                                  jgumbel._considered_counts(m, int(ph[-1]) + 1))


def test_row_selects_equal_one_hot_sums():
    """The port's gathers give what JAX's one-hot sums give, for float,
    bool, int and board rows."""
    rng = np.random.default_rng(0)
    M, B = 7, 33
    node = rng.integers(0, M, B)
    ohm = jglm._oh_m(jnp.asarray(node, jnp.int32), M)
    X = rng.normal(size=(M, 54, B)).astype(np.float32)
    Xb = rng.random((M, 54, B)) < 0.5
    S = rng.integers(-5, 5, (M, B)).astype(np.int32)
    Sb = rng.random((M, B)) < 0.5
    boards = rng.integers(-6, 7, (M, 3, 9, B)).astype(np.int8)
    n = t(node)
    np.testing.assert_array_equal(tglm._row(t(X), n).numpy(), np.asarray(jglm._row(X, ohm)))
    np.testing.assert_array_equal(tglm._row(t(Xb), n).numpy(), np.asarray(jglm._row_bool(Xb, ohm)))
    np.testing.assert_array_equal(tglm._scal(t(S), n).numpy(), np.asarray(jglm._scal(S, ohm)))
    np.testing.assert_array_equal(tglm._scal(t(Sb), n).numpy(), np.asarray(jglm._scal_bool(Sb, ohm)))
    got = tglm._board_at(t(boards), n)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(jglm._board_at(boards, ohm)))


def test_top_k_is_tie_inclusive_and_equals_jax():
    rng = np.random.default_rng(1)
    score = rng.integers(0, 6, (54, 40)).astype(np.float32)   # many ties
    score[rng.random((54, 40)) < 0.3] = -np.inf
    for k in (1, 2, 4, 8, 16):
        got = tglm._top_k_mask_lm(t(score), k).numpy()
        np.testing.assert_array_equal(got, np.asarray(jglm._top_k_mask_lm(score, k)))
        kth = np.sort(score, axis=0)[-k]
        np.testing.assert_array_equal(got, score >= kth[None])  # ties all in


def test_mixed_value_equals_jax():
    rng = np.random.default_rng(2)
    B = 64
    n = rng.integers(0, 3, (54, B)).astype(np.float32)
    q = rng.uniform(-1, 1, (54, B)).astype(np.float32)
    priors = rng.dirichlet(np.ones(54), B).T.astype(np.float32)
    legal = rng.random((54, B)) < 0.6
    n[:, :4] = 0                                                # nothing visited
    v_hat = rng.uniform(-1, 1, B).astype(np.float32)
    want = np.asarray(jglm._mixed_value_lm(v_hat, q, n, priors, legal))
    got = tglm._mixed_value_lm(t(v_hat), t(q), t(n), t(priors), t(legal)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[:4], v_hat[:4])
    one = tgumbel._mixed_value(t(v_hat[5]), t(q[:, 5]), t(n[:, 5]), t(priors[:, 5]),
                               t(legal[:, 5]))
    np.testing.assert_allclose(float(one), float(jgumbel._mixed_value(
        v_hat[5], q[:, 5], n[:, 5], priors[:, 5], legal[:, 5])), atol=1e-6)


def test_winning_actions_and_evaluate_equal_jax(nets):
    jnet, params, tnet = nets
    board, cur = positions(96, 9, 3)
    got = tglm._winning_actions_lm(t(board), t(cur)).numpy()
    want = np.asarray(jglm._winning_actions_lm(jnp.asarray(board), jnp.asarray(cur)))
    np.testing.assert_array_equal(got, want)
    assert want.any()
    p1, v1, m1 = (np.asarray(x) for x in jglm._evaluate_lm(japply(jnet), params,
                                                          jnp.asarray(board), jnp.asarray(cur)))
    with torch.no_grad():
        p2, v2, m2 = (x.numpy() for x in tglm._evaluate_lm(tnet, t(board), t(cur)))
    np.testing.assert_array_equal(m2, m1)
    np.testing.assert_allclose(p2, p1, atol=1e-6, rtol=0)
    np.testing.assert_allclose(v2, v1, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# Gumbel
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_gumbel_lm(nets):
    """JAX's lane-major search on the exact net, jitted once for both noise
    cases."""
    jnet, params, _ = nets
    return jax.jit(lambda b, c, g: jglm.gumbel_search_lm(
        japply(jnet), params, b, c, jax.random.PRNGKey(7), GCFG, noise=g))


@pytest.mark.parametrize("noise", ["zero", "shared"])
def test_gumbel_search_lm_equals_jax(nets, jax_gumbel_lm, noise):
    tnet = nets[2]
    board, cur = positions(24, 7, 5)
    g = (np.zeros((54, 24), np.float32) if noise == "zero" else
         np.asarray(jax.random.gumbel(jax.random.PRNGKey(11), (54, 24), jnp.float32)))
    want = jax_gumbel_lm(board, cur, g)
    got = tglm.gumbel_search_lm(tnet, t(board), t(cur), None, TGCFG, noise=t(g))
    assert got[0].dtype == torch.int32 and got[1].shape == (24, 54)
    assert_tree_outputs(got, want)


def test_gumbel_search_batch_first_equals_jax_vmapped(nets):
    """The batch-first contract against JAX's vmapped per-root search with
    the same [B, 54] noise rows; the noise changes actions somewhere."""
    jnet, params, tnet = nets
    board, cur = positions(24, 7, 6)
    boards_bf = np.ascontiguousarray(board.transpose(2, 0, 1))
    g = np.asarray(jax.random.gumbel(jax.random.PRNGKey(12), (24, 54), jnp.float32))
    want = jgumbel.gumbel_search(japply(jnet), params, jnp.asarray(boards_bf), jnp.asarray(cur),
                                 jax.random.PRNGKey(7), GCFG, noise=jnp.asarray(g))
    got = tgumbel.gumbel_search(tnet, t(boards_bf), t(cur), None, TGCFG, noise=t(g))
    assert_tree_outputs(got, want)
    a0 = tgumbel.gumbel_search(tnet, t(boards_bf), t(cur), None, TGCFG,
                               noise=torch.zeros(24, 54))[0]
    assert (a0 != got[0]).any()


@pytest.mark.parametrize("search", ["gumbel", "puct"])
def test_generator_draws_equal_the_injected_fields(nets, search):
    """The self-play path draws its root noise from the generator: the
    search gives what the injected-field path gives on the same draws."""
    _, _, tnet = nets
    board, cur = map(t, positions(32, 6, 7))
    gen = lambda: torch.Generator().manual_seed(3)   # noqa: E731
    if search == "gumbel":
        cfg = tgumbel.GumbelConfig(num_sims=24, max_considered=4)
        a = tglm.gumbel_search_lm(tnet, board, cur, gen(), cfg)
        g = tbc.gumbel_field(gen(), (54, 32), CPU)
        b = tglm.gumbel_search_lm(tnet, board, cur, None, cfg, noise=g)
    else:
        cfg = tmcts.MCTSConfig(num_sims=24, max_depth=3, dirichlet_alpha=0.5)
        a = tmlm.mcts_search_lm(tnet, board, cur, gen(), cfg)
        g = torch._standard_gamma(torch.full((54, 32), 0.5), generator=gen())
        b = tmlm.mcts_search_lm(tnet, board, cur, None, cfg, dirichlet=g)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def tactic_board(moves):
    b = rules_np.empty_board()
    for player, action in moves:
        b = rules_np.apply_action(b, player, action)
    return t(np.stack([b], axis=-1)), torch.zeros(1, dtype=torch.int32)


@pytest.fixture(scope="module")
def jax_test_net():
    """tests/test_gumbel_lm.py's net (bfloat16, flax init from key 0) in
    torch."""
    net = jac.MLPActorCritic(hidden_sizes=(64, 64))
    params = net.init(jax.random.PRNGKey(0), jnp.zeros((1, 117), jnp.int8))
    tnet = tac.MLPActorCritic(hidden_sizes=(64, 64), device=CPU)
    tnet.load_state_dict(actor_critic_params_from_flax(jax.tree.map(np.asarray, params), "mlp"))
    return tnet


def jax_root_noise(seed):
    """The root field gumbel_lm_policy draws from PRNGKey(seed) at B=1."""
    return t(jax.random.gumbel(jax.random.PRNGKey(seed), (54, 1), jnp.float32))


def test_gumbel_finds_immediate_win(jax_test_net):
    board, cur = tactic_board([(0, 0), (1, 8), (0, 10), (1, 16)])
    a = int(tglm.gumbel_search_lm(jax_test_net, board, cur, None,
                                  tgumbel.GumbelConfig(num_sims=16), noise=jax_root_noise(1))[0][0])
    nb = rules_np.apply_action(board[..., 0].numpy(), 0, a)
    assert rules_np.line_winner(nb) == 1, a


def test_gumbel_blocks_forced_loss(jax_test_net):
    board, cur = tactic_board([(1, 36), (1, 46), (0, 8)])
    a = int(tglm.gumbel_search_lm(jax_test_net, board, cur, None,
                                  tgumbel.GumbelConfig(num_sims=32), noise=jax_root_noise(2))[0][0])
    nb = rules_np.apply_action(board[..., 0].numpy(), 0, a)
    for r in np.nonzero(rules_np.legal_mask(nb, 1))[0]:
        assert rules_np.line_winner(rules_np.apply_action(nb, 1, int(r))) != -1, (a, r)


def test_gumbel_actions_always_legal(jax_test_net):
    B = 16
    state = tbc.reset_planes(B, CPU)
    pol = tgumbel.gumbel_policy(jax_test_net, tgumbel.GumbelConfig(num_sims=12))
    gen = torch.Generator().manual_seed(0)
    for _ in range(8):
        mask = tbc.legal_mask_planes(state.board, state.current)
        actions = pol(gen, state.board, state.current)
        assert actions.dtype == torch.int32
        assert mask[actions.long(), torch.arange(B)].all()
        state = tbc.autoreset_planes(tbc.step_planes(state, actions))
