"""Port parity for the PUCT searches: the lane-major search, its
batch-first entry point and the evaluation policies, gobblet_rl_torch
against gobblet_rl_tpu on the CPU.

The net on both sides is the exact float32 MLP of ``torch_parity.py``.
Without root noise, and with JAX's gamma draws injected as the
``dirichlet=`` field, the visit counts and the root wins must be identical
on every root and the visited Q-values agree within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gobblet_rl_torch.ops import batched_core as tbc
from gobblet_rl_torch.search import mcts as tmcts
from gobblet_rl_torch.search import mcts_lm as tmlm
from gobblet_rl_tpu.core import rules_np
from gobblet_rl_tpu.search import mcts as jmcts
from gobblet_rl_tpu.search import mcts_lm as jmlm
from tests.torch_parity import CPU, exact_nets, japply, positions, t


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


def assert_puct_outputs(got, want):
    v1, q1, rw1 = (np.asarray(x) for x in want)
    v2, q2, rw2 = (x.numpy() for x in got)
    np.testing.assert_array_equal(v2, v1)
    np.testing.assert_array_equal(rw2, rw1)
    vis = v1 > 0
    np.testing.assert_allclose(q2[vis], q1[vis], atol=1e-6, rtol=0)
    assert (q2[~vis] == -np.inf).all()


@pytest.mark.parametrize("alpha", [0.0, 0.5])
def test_mcts_search_lm_equals_jax(nets, alpha):
    """Noise off, and with JAX's gamma field (mcts_lm.py:65) injected."""
    jnet, params, tnet = nets
    board, cur = positions(16, 5, 8)
    key = jax.random.PRNGKey(9)
    want = jmlm.mcts_search_lm(japply(jnet), params, jnp.asarray(board), jnp.asarray(cur), key,
                               jmcts.MCTSConfig(num_sims=16, dirichlet_alpha=alpha))
    field = t(jax.random.gamma(key, alpha, (54, 16), jnp.float32)) if alpha else None
    got = tmlm.mcts_search_lm(tnet, t(board), t(cur), None,
                              tmcts.MCTSConfig(num_sims=16, dirichlet_alpha=alpha),
                              dirichlet=field)
    assert_puct_outputs(got, want)


@pytest.mark.parametrize("alpha", [0.0, 0.5])
def test_mcts_search_batch_first_equals_jax_vmapped(nets, alpha):
    """The batch-first contract against JAX's vmapped search; with noise,
    the gamma rows are rebuilt lane by lane from jax.random.split(key, B),
    as mcts.py:156 and :273 draw them."""
    jnet, params, tnet = nets
    board, cur = positions(16, 5, 9)
    boards_bf = np.ascontiguousarray(board.transpose(2, 0, 1))
    key = jax.random.PRNGKey(4)
    want = jmcts.mcts_search(japply(jnet), params, jnp.asarray(boards_bf), jnp.asarray(cur), key,
                             jmcts.MCTSConfig(num_sims=16, dirichlet_alpha=alpha))
    field = None
    if alpha:
        field = t(np.stack([np.asarray(jax.random.gamma(k, alpha, (54,), jnp.float32))
                            for k in jax.random.split(key, 16)]))
    got = tmcts.mcts_search(tnet, t(boards_bf), t(cur), None,
                            tmcts.MCTSConfig(num_sims=16, dirichlet_alpha=alpha),
                            dirichlet=field)
    assert_puct_outputs(got, want)


def test_dirichlet_from_generator_moves_the_visits(nets):
    board, cur = map(t, positions(16, 3, 10))
    cfg = tmcts.MCTSConfig(num_sims=16, dirichlet_alpha=0.5)

    def visits(cfg, seed):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        return tmlm.mcts_search_lm(nets[2], board, cur, gen, cfg)[0]

    v0, v1, v1b, v2 = (visits(tmcts.MCTSConfig(num_sims=16), None), visits(cfg, 1),
                       visits(cfg, 1), visits(cfg, 2))
    assert torch.equal(v1, v1b) and not torch.equal(v1, v0) and not torch.equal(v1, v2)
    assert (v1.sum(-1) == 16).all()


def test_mcts_policies_equal_jax(nets):
    """The evaluation policies' final selection (proven outcomes over
    visits, never illegal) gives JAX's actions, through both entry
    points."""
    jnet, params, tnet = nets
    board, cur = positions(12, 4, 6)
    want = np.asarray(jmlm.mcts_lm_policy(jnet, params, jmcts.MCTSConfig(num_sims=12))(
        jax.random.PRNGKey(11), jnp.asarray(board), jnp.asarray(cur)))
    tcfg = tmcts.MCTSConfig(num_sims=12)
    for pol in (tmlm.mcts_lm_policy(tnet, tcfg), tmcts.mcts_policy(tnet, tcfg)):
        np.testing.assert_array_equal(pol(None, t(board), t(cur)).numpy(), want)


def test_mcts_temperature_samples_from_the_clamped_scores(nets):
    """With temperature > 0 the logits are log(max(score, 1e-9)) / t, as in
    JAX (mcts_lm.py:217): an illegal action (score -inf) gets the logit of
    a legal one scored at or below 0.  Where some legal action scores
    above 0 the draw is legal; where every visited move is a proven loss
    (score visits - 1e6), all 54 actions tie and an illegal one can be
    drawn, in the reference too."""
    board, cur = map(t, positions(64, 4, 11))
    v, q, rw = tmlm.mcts_search_lm(nets[2], board, cur, None, tmcts.MCTSConfig(num_sims=8))
    mask = tbc.legal_mask_planes(board, cur)
    score = v + 1e9 * rw + 1e6 * (q >= 0.999) - 1e6 * (torch.isfinite(q) & (q <= -0.999))
    scored = (torch.where(mask.t(), score, 0.0) > 1e-9).any(-1)
    assert 0 < int((~scored).sum()) < 8          # this position set has both kinds
    pol = tmlm.mcts_lm_policy(nets[2], tmcts.MCTSConfig(num_sims=8, temperature=1.0))
    gen = torch.Generator().manual_seed(0)
    a, b = pol(gen, board, cur), pol(gen, board, cur)
    for x in (a, b):
        assert mask[x.long(), torch.arange(64)][scored].all()
    assert (a != b).any()   # the temperature draws from the generator


def test_mcts_blocks_forced_loss(nets):
    b = rules_np.empty_board()
    for player, action in [(1, 36), (1, 46), (0, 8)]:
        b = rules_np.apply_action(b, player, action)
    pol = tmcts.mcts_policy(nets[2], tmcts.MCTSConfig(num_sims=32))
    a = int(pol(None, t(b[..., None]), torch.zeros(1, dtype=torch.int32))[0])
    nb = rules_np.apply_action(b, 0, a)
    for r in np.nonzero(rules_np.legal_mask(nb, 1))[0]:
        assert rules_np.line_winner(rules_np.apply_action(nb, 1, int(r))) != -1, (a, r)
