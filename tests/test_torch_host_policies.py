"""The torch port's host policies against the JAX package's, on the CPU.

* ``AlphaBetaGobbletPolicy``: the same moves as JAX's on every position of
  a few seeded games (tolerance 0: moves are integers).  The two libraries
  keep their tables apart, and a search's move ordering reads its table:
  both solver tables are cleared first, both policies are called in the
  same order with the same seed, and the seeds (hence the salt chains) are
  used by no other test.  The solver tables are released at the end.
* ``RandomAdmissiblePolicy`` and ``random_admissible_action``: the same
  draws as JAX's under one seed (tolerance 0).
* ``batched_random_admissible``: with JAX's own Gumbel field injected, the
  actions of ``jax.random.categorical`` exactly; from a generator, legal
  and uniform over the legal set (a chi-square bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gobblet_rl_torch import policies as tpolicies
from gobblet_rl_torch.core import observe, rules_np
from gobblet_rl_torch.native import engine as tengine
from gobblet_rl_tpu import policies as jpolicies
from gobblet_rl_tpu.native import engine as jengine
from gobblet_rl_tpu.policies import random_policy as jrandom


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


def seeded_positions(seed, games=3, max_plies=30):
    """(observation, mask) of the mover at every live position of
    ``games`` random games, numpy-seeded, on the port's board."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(games):
        board, player = rules_np.empty_board(), 0
        for _ in range(max_plies):
            obs, mask = observe.observe_np(board, player, player)
            out.append((obs, mask))
            a = int(rng.choice(np.nonzero(mask)[0]))
            board = rules_np.apply_action(board, player, a)
            if rules_np.line_winner(board):
                break
            player = 1 - player
    return out


def test_board_positions_are_reference_observations():
    """The position helper's observations are the AEC env's: the board
    rebuilt from each is the one it came from."""
    for obs, mask in seeded_positions(3, games=1):
        board, agent = tpolicies.greedy.board_from_observation(obs)
        again, again_mask = observe.observe_np(board, agent, agent)
        np.testing.assert_array_equal(again, obs)
        np.testing.assert_array_equal(again_mask, mask)


@pytest.mark.parametrize("depth,seed", [(2, 7101), (4, 7102), (6, 7103)])
def test_alphabeta_policy_equals_jax(depth, seed):
    jengine.load()
    tengine.solve_tt_clear()
    jengine.solve_tt_clear()
    tpol = tpolicies.AlphaBetaGobbletPolicy(depth=depth, seed=seed)
    jpol = jpolicies.AlphaBetaGobbletPolicy(depth=depth, seed=seed)
    positions = seeded_positions(seed, games=3 if depth < 6 else 2)
    assert len(positions) >= 12
    for i, (obs, mask) in enumerate(positions):
        ja = jpol.compute_action(obs, mask)
        ta = tpol.compute_action(obs, mask)
        assert ta == ja, (i, ta, ja)
        assert mask[ta] == 1
    assert tpol._salt == int(jpol._salt)


def test_alphabeta_policy_falls_back_to_lowest_legal():
    """A mask that forbids the engine's move gets the lowest legal action,
    as in JAX (the engine's move is legal on the board, not in the mask)."""
    obs, mask = seeded_positions(5, games=1)[4]
    tpol = tpolicies.AlphaBetaGobbletPolicy(depth=2, seed=7104)
    jpol = jpolicies.AlphaBetaGobbletPolicy(depth=2, seed=7104)
    first = tpolicies.AlphaBetaGobbletPolicy(depth=2, seed=7104).compute_action(obs, mask)
    jpolicies.AlphaBetaGobbletPolicy(depth=2, seed=7104).compute_action(obs, mask)
    narrowed = mask.copy()
    narrowed[first] = 0
    legal = np.flatnonzero(narrowed)
    assert tpol.compute_action(obs, narrowed) == jpol.compute_action(obs, narrowed) == legal[0]
    empty = np.zeros_like(mask)
    assert tpol.compute_action(obs, empty) == jpol.compute_action(obs, empty) == 0


def test_random_admissible_policy_equals_jax():
    positions = seeded_positions(11, games=4)
    tpol, jpol = tpolicies.RandomAdmissiblePolicy(seed=3), jpolicies.RandomAdmissiblePolicy(seed=3)
    for obs, mask in positions:
        assert tpol.compute_action(obs, mask) == jpol.compute_action(obs, mask)
    masks = np.stack([m for _, m in positions[:16]])
    assert tpol.compute_actions({"action_mask": masks}) == \
        jpol.compute_actions({"action_mask": masks})

    np.random.seed(17)
    t = [tpolicies.random_admissible_action(m) for _, m in positions]
    np.random.seed(17)
    j = [jrandom.random_admissible_action(m) for _, m in positions]
    assert t == j
    rng_t, rng_j = np.random.default_rng(4), np.random.default_rng(4)
    assert [tpolicies.random_admissible_action(m, rng_t) for _, m in positions] == \
        [jrandom.random_admissible_action(m, rng_j) for _, m in positions]


def test_batched_random_admissible_equals_jax_categorical():
    """JAX's categorical is the argmax of ``gumbel(key) + logits``: with that
    field injected, the port draws JAX's actions for the same key."""
    positions = seeded_positions(13, games=6)
    masks = np.stack([m for _, m in positions]).astype(np.int8)
    masks[0] = 0                              # no legal action: index 0 in both
    masks[1] = 0
    masks[1, 53] = 1                          # one legal action
    for k in range(3):
        key = jax.random.PRNGKey(k)
        want = np.asarray(jrandom.batched_random_admissible(key, jnp.asarray(masks)))
        field = np.array(jax.random.gumbel(key, masks.shape, jnp.float32))
        got = tpolicies.batched_random_admissible(None, torch.from_numpy(masks),
                                                  gumbel=torch.from_numpy(field))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    assert got[1] == 53 and got[0] == 0


def test_batched_random_admissible_is_uniform_over_legal():
    """4 masks with 1, 5, 17 and 54 legal actions, 20,000 draws each: every
    action legal, and the counts of the three masks with a choice each
    within the chi-square bound of the uniform at p = 2.5e-5."""
    masks = torch.zeros((4, 54), dtype=torch.bool)
    masks[0, 9] = True
    masks[1, [0, 7, 19, 33, 50]] = True
    masks[2, ::3] = True                       # 18 actions
    masks[2, 3] = False                        # 17
    masks[3] = True
    n = 20_000
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([tpolicies.batched_random_admissible(gen, masks) for _ in range(n)])
    assert masks[torch.arange(4).expand(n, 4), draws.long()].all()
    with pytest.raises(ValueError):
        tpolicies.batched_random_admissible(None, masks)
    # chi-square critical values at p = 2.5e-5 (scipy.stats.chi2.isf)
    critical = {4: 26.507, 16: 49.764, 53: 105.392}
    for i in (1, 2, 3):
        legal = masks[i].nonzero().squeeze(1)
        counts = torch.bincount(draws[:, i].long(), minlength=54)[legal].double()
        expected = n / len(legal)
        chi2 = float(((counts - expected) ** 2 / expected).sum())
        assert chi2 < critical[len(legal) - 1], (i, chi2)
