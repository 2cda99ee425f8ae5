"""The torch port's single-env ``NativeEngine`` (ctypes over csrc/gobblet.cpp,
the port's own build) against the port's NumPy rules and against the JAX
package's ``NativeEngine``, on the CPU.

Twins of ``tests/test_native.py`` (random-playout parity with the rules,
the illegal no-op, greedy beats random, the alpha-beta move legal, taking
the win and the host policy's full game) and of the native check of
``tests/test_exhaustive.py`` (legal masks and winners on every board of
the depth-2 tree), plus parity with JAX's engine: both libraries are built
from the same source, so the integer answers of the greedy, the playouts
and the scripted matches are equal (tolerance 0).  Alpha-beta is keyed on
its salt in each library's table; the salts here are used by no other
test.  The solver tables of both libraries are released at the end of the
module.
"""

import numpy as np
import pytest
import torch

from gobblet_rl_torch.core import rules_np
from gobblet_rl_torch.native import engine as native
from gobblet_rl_tpu.native import engine as jnative


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
    native.solve_tt_clear()
    jnative.solve_tt_clear()


def test_available_and_own_build():
    assert native.available()
    eng = native.NativeEngine()
    assert eng.lib is native.load()
    assert "gobblet_rl_torch" in eng.lib._name and "gobblet_rl_tpu" not in eng.lib._name


def test_native_parity_random_playouts():
    eng = native.NativeEngine()
    rng = np.random.default_rng(0)
    for _ in range(10):
        eng.reset()
        board = rules_np.empty_board()
        player = 0
        for _ in range(60):
            m_native = eng.legal_mask(player)
            m_np = rules_np.legal_mask(board, player)
            np.testing.assert_array_equal(m_native, m_np)

            action = int(rng.choice(np.nonzero(m_np)[0]))
            eng.apply(player, action)
            board = rules_np.apply_action(board, player, action)
            np.testing.assert_array_equal(eng.board.reshape(3, 9), board)
            assert eng.winner() == rules_np.line_winner(board)
            if eng.winner() != 0:
                break
            player = 1 - player


def test_native_is_legal_matches_rules():
    rng = np.random.default_rng(1)
    eng = native.NativeEngine()
    eng.reset()
    board, player = rules_np.empty_board(), 0
    for _ in range(12):
        for a in range(54):
            assert eng.is_legal(player, a) == rules_np.is_legal(board, player, a)
        a = int(rng.choice(np.nonzero(rules_np.legal_mask(board, player))[0]))
        eng.apply(player, a)
        board = rules_np.apply_action(board, player, a)
        if eng.winner():
            break
        player = 1 - player


def test_native_illegal_noop():
    eng = native.NativeEngine()
    eng.reset()
    eng.apply(0, 0)
    snapshot = eng.board.copy()
    eng.apply(1, 0)          # equal size on an occupied cell: illegal
    np.testing.assert_array_equal(eng.board, snapshot)
    eng.apply(1, 99)         # out of range: ignored
    eng.apply(1, -5)
    np.testing.assert_array_equal(eng.board, snapshot)


def test_native_greedy_beats_random():
    eng = native.NativeEngine()
    wins0, winners = eng.play_match(200, depth_p0=2, depth_p1=0, seed=3)
    decided = int((winners != 0).sum())
    assert decided > 150
    assert wins0 / decided > 0.9


def _enumerate_depth2():
    """All boards after exactly 2 legal plies (player 0 to move)."""
    seen = {}
    root = rules_np.empty_board()
    for a1 in range(54):
        b1 = rules_np.apply_action(root, 0, a1)
        for a2 in np.nonzero(rules_np.legal_mask(b1, 1))[0]:
            b2 = rules_np.apply_action(b1, 1, int(a2))
            seen[b2.tobytes()] = b2
    return list(seen.values())


def test_depth2_tree_legal_mask_and_winner():
    boards = _enumerate_depth2()
    assert len(boards) > 2500
    eng = native.NativeEngine()
    for board in boards:
        eng.board[:] = board.flatten()
        for player in (0, 1):
            np.testing.assert_array_equal(eng.legal_mask(player),
                                          rules_np.legal_mask(board, player))
        assert eng.winner() == rules_np.line_winner(board)


def _random_midgame(rng, plies=6):
    """A live position reached by random play, and the player to move."""
    eng = native.NativeEngine()
    while True:
        eng.reset()
        player = 0
        for _ in range(plies):
            legal = np.nonzero(eng.legal_mask(player))[0]
            eng.apply(player, int(rng.choice(legal)))
            if eng.winner() != 0:
                break
            player = 1 - player
        if eng.winner() == 0:
            return eng, player


def _after(eng, player, action):
    nxt = native.NativeEngine()
    nxt.board[:] = eng.board
    nxt.apply(player, int(action))
    return nxt


def test_alphabeta_action_always_legal():
    rng = np.random.default_rng(11)
    for trial in range(25):
        eng, player = _random_midgame(rng, plies=int(rng.integers(0, 12)))
        a = eng.alphabeta_action(player, depth=4, salt=7300 + trial)
        assert eng.is_legal(player, a), (trial, a)


def test_alphabeta_takes_immediate_win():
    rng = np.random.default_rng(23)
    checked = 0
    for trial in range(300):
        eng, player = _random_midgame(rng, plies=int(rng.integers(4, 14)))
        sign = 1 if player == 0 else -1
        legal = np.nonzero(eng.legal_mask(player))[0]
        if not any(_after(eng, player, a).winner() == sign for a in legal):
            continue
        chosen = eng.alphabeta_action(player, depth=2, salt=7400 + trial)
        assert _after(eng, player, chosen).winner() == sign, (trial, chosen)
        checked += 1
        if checked >= 10:
            break
    assert checked >= 5  # the sampler found enough tactical positions


def test_alphabeta_blocks_a_threat():
    """Where the opponent wins next ply unless the mover answers, and some
    answer leaves no win in one, the alpha-beta move is such an answer."""
    rng = np.random.default_rng(29)
    checked = 0
    for trial in range(600):
        eng, player = _random_midgame(rng, plies=int(rng.integers(4, 14)))
        sign = 1 if player == 0 else -1
        legal = np.nonzero(eng.legal_mask(player))[0]
        if any(_after(eng, player, a).winner() == sign for a in legal):
            continue  # a win in one is taken instead (previous test)

        def opponent_wins_next(child):
            reply = np.nonzero(child.legal_mask(1 - player))[0]
            return any(_after(child, 1 - player, r).winner() == -sign for r in reply)

        safe = []
        for a in legal:
            child = _after(eng, player, a)
            if child.winner() == 0 and not opponent_wins_next(child):
                safe.append(int(a))
        if not safe or len(safe) == len(legal):
            continue
        chosen = eng.alphabeta_action(player, depth=3, salt=7500 + trial)
        assert chosen in safe, (trial, chosen, safe)
        checked += 1
        if checked >= 8:
            break
    assert checked >= 4


def test_engine_equals_jax_engine():
    """Greedy moves (one shared RNG state), a random playout and both
    scripted matches give JAX's integers exactly."""
    eng, jeng = native.NativeEngine(), jnative.NativeEngine()
    eng.seed(5)
    jeng.seed(5)
    rng = np.random.default_rng(31)
    eng.reset()
    jeng.reset()
    player = 0
    for _ in range(30):
        for depth in (1, 2):
            assert eng.greedy_action(player, depth) == jeng.greedy_action(player, depth)
        a = int(rng.choice(np.nonzero(eng.legal_mask(player))[0]))
        eng.apply(player, a)
        jeng.apply(player, a)
        np.testing.assert_array_equal(eng.board, jeng.board)
        if eng.winner():
            eng.reset()
            jeng.reset()
            player = 0
        else:
            player = 1 - player
    assert eng.rng_state.value == jeng.rng_state.value

    eng.reset()
    jeng.reset()
    ep, w = eng.random_playout(20_000, seed=7)
    jep, jw = jeng.random_playout(20_000, seed=7)
    assert ep == jep and ep > 1_000
    np.testing.assert_array_equal(w, jw)
    np.testing.assert_array_equal(eng.board, jeng.board)

    w0, winners = eng.play_match(40, 2, 1, seed=9)
    jw0, jwinners = jeng.play_match(40, 2, 1, seed=9)
    assert w0 == jw0
    np.testing.assert_array_equal(winners, jwinners)

    m = eng.play_match2(6, 2, 3, 1, 2, seed=7601)
    jm = jeng.play_match2(6, 2, 3, 1, 2, seed=7601)
    assert m[0] == jm[0]
    np.testing.assert_array_equal(m[1], jm[1])


def test_alphabeta_host_policy_full_game():
    """The port's ``AlphaBetaGobbletPolicy`` wins a game against the random
    policy on the port's AEC env (two alpha-beta agents can cycle forever:
    the game has no repetition rule)."""
    from gobblet_rl_torch import gobblet_v1
    from gobblet_rl_torch.policies import AlphaBetaGobbletPolicy, RandomAdmissiblePolicy

    env = gobblet_v1.env(render_mode=None)
    env.reset(seed=4)
    expert_seat = env.possible_agents[0]
    pol = {
        env.possible_agents[0]: AlphaBetaGobbletPolicy(depth=3, seed=7700),
        env.possible_agents[1]: RandomAdmissiblePolicy(seed=1),
    }
    final_rewards = {}
    for agent in env.agent_iter(max_iter=300):
        obs, reward, term, trunc, info = env.last()
        if term or trunc:
            action = None
        else:
            action = pol[agent].compute_action(obs["observation"], obs["action_mask"])
            assert obs["action_mask"][action] == 1
        env.step(action)
        for a, r in env.rewards.items():  # per-step rewards, summed over the plies
            final_rewards[a] = final_rewards.get(a, 0) + r
    assert final_rewards[expert_seat] == 1, final_rewards
