"""Port parity for the batched greedy (policies/greedy_jax.py): the torch
greedy against the JAX one under the same Gumbel field, bit for bit, plus
twins of the JAX module's tactical tests.

The JAX greedy draws its noise as ``jax.random.gumbel(key, (54, B))``; the
test rebuilds that field from the same key and passes it to the torch
greedy as ``gumbel=``, so the actions must be identical (tolerance 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gobblet_rl_torch.ops import batched_core as tbc
from gobblet_rl_torch.policies import greedy_jax as tg
from gobblet_rl_tpu.core import rules_np
from gobblet_rl_tpu.policies import greedy_jax as jg

CPU = torch.device("cpu")

# A reachable position (found by random play) where player 0 has no
# immediate win and every legal move uncovers an opponent line.
NO_NON_LOSING = [[-1, 0, 0, 0, 1, 2, 0, 0, -2],
                 [0, 0, 3, 0, 4, -4, -3, 0, 0],
                 [0, 0, -5, 0, -6, 0, 6, 0, 5]]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes on a few cores, where torch's thread pools would oversubscribe
    them and small ops slow down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def immediate_win_board():
    b = rules_np.empty_board()
    for player, action in ((0, 0), (1, 8), (0, 10), (1, 16)):
        b = rules_np.apply_action(b, player, action)
    return b                 # player 0 to move; cell 2 completes 0, 1, 2


def block_board():
    b = rules_np.empty_board()
    for player, action in ((1, 36), (1, 46), (0, 8)):
        b = rules_np.apply_action(b, player, action)
    return b                 # player 0 to move; player 1 threatens cell 2


def random_positions(n, seed, max_plies=24):
    """Reachable live positions after 0..max_plies-1 random plies (a move
    that would end the game is skipped), both players to move."""
    rng = np.random.default_rng(seed)
    plies = rng.integers(0, max_plies, n)
    board = torch.zeros((3, 9, n), dtype=torch.int8)
    cur = torch.zeros(n, dtype=torch.int32)
    for t in range(max_plies):
        g = torch.from_numpy(rng.gumbel(size=(54, n)).astype(np.float32))
        a = tbc.sample_random_lm(None, tbc.legal_mask_planes(board, cur), g)
        nb = tbc.apply_action_unchecked(board, cur, a)
        go = torch.from_numpy(plies > t) & (tbc.winner_planes(tbc.flat_planes(nb)) == 0)
        board = torch.where(go[None, None], nb, board)
        cur = torch.where(go, 1 - cur, cur)
    return board, cur


def position_set():
    board, cur = random_positions(1024, 0)
    extra = np.stack([immediate_win_board(), block_board(), np.array(NO_NON_LOSING, np.int8)],
                     axis=-1)
    board = torch.cat([board, torch.from_numpy(extra)], dim=-1)
    cur = torch.cat([cur, torch.zeros(3, dtype=torch.int32)])
    return board, cur


def classes(board, cur):
    """(immediate win, no safe move, no legal non-losing move) per env."""
    B = board.shape[-1]
    sign = tbc.player_sign_planes(cur)
    mask = tbc.legal_mask_planes(board, cur)
    boards1 = tg._apply_all_actions(board, cur)
    w1 = tbc.winner_planes(tbc.flat_planes(boards1)).view(54, B)
    win = (mask & (w1 == sign)).any(0)
    opp = (-sign).repeat(54)
    opp_can_win = torch.zeros((54, B), dtype=torch.bool)
    for r in range(54):
        opp_can_win |= (tg.reply_winner(boards1, opp, r) == opp).view(54, B)
    safe = (mask & (w1 == 0) & ~opp_can_win).any(0)
    non_losing = (mask & (w1 != -sign)).any(0)
    return win, ~win & ~safe, ~win & ~non_losing


@pytest.mark.parametrize("depth", [1, 2])
def test_greedy_matches_jax_under_injected_field(depth):
    board, cur = position_set()
    win, no_safe, no_non_losing = classes(board, cur)
    # the set covers every branch of the decision rule, for both players
    assert int(win.sum()) > 100 and int(no_safe.sum()) > 10 and int(no_non_losing.sum()) >= 1
    assert int((cur == 1).sum()) > 400 and int((cur == 0).sum()) > 400
    key = jax.random.PRNGKey(10 + depth)
    want = np.asarray(jg.greedy_actions(key, jnp.asarray(board.numpy()),
                                        jnp.asarray(cur.numpy()), depth))
    field = torch.from_numpy(np.array(jax.random.gumbel(key, (54, board.shape[-1]))))
    got = tg.greedy_actions(None, board, cur, depth, gumbel=field)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_reply_winner_equals_step_planes_winner():
    board, cur = random_positions(96, 1)
    boards1 = tg._apply_all_actions(board, cur)
    n = boards1.shape[-1]
    opp_cur = (1 - cur).repeat(54)
    opp_sign = tbc.player_sign_planes(opp_cur)
    for r in range(54):
        actions = torch.full((n,), r, dtype=torch.int32)
        state = tbc.PlanesState(
            board=boards1, current=opp_cur, turn=torch.zeros(n, dtype=torch.int32),
            done=torch.zeros(n, dtype=torch.bool), winner=torch.zeros(n, dtype=torch.int8),
            last_action=actions, rewards=torch.zeros((2, n)))
        want = tbc.step_planes(state, actions).winner
        got = tg.reply_winner(boards1, opp_sign, r)
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want.numpy(), err_msg=f"reply {r}")


def test_actions_legal_and_noise_source():
    board, cur = random_positions(256, 2)
    mask = tbc.legal_mask_planes(board, cur)
    a = tg.greedy_actions(torch.Generator().manual_seed(0), board, cur, 2)
    assert mask[a.long(), torch.arange(256)].all()
    with pytest.raises(ValueError):
        tg.greedy_actions(None, board, cur, 2)


def test_takes_immediate_win():
    b = immediate_win_board()
    board = torch.from_numpy(b[..., None].copy())
    a = int(tg.greedy_actions(torch.Generator().manual_seed(0), board,
                              torch.zeros(1, dtype=torch.int32), depth=2)[0])
    assert a % 9 == 2  # completes the 0,1,2 line
    assert rules_np.line_winner(rules_np.apply_action(b, 0, a)) == 1


def test_blocks_opponent_win():
    b = block_board()
    board = torch.from_numpy(b[..., None].copy())
    for seed in range(5):
        a = int(tg.greedy_actions(torch.Generator().manual_seed(seed), board,
                                  torch.zeros(1, dtype=torch.int32), depth=2)[0])
        nb = rules_np.apply_action(b, 0, a)
        # after our move the opponent has no winning reply
        for r in np.nonzero(rules_np.legal_mask(nb, 1))[0]:
            assert rules_np.line_winner(rules_np.apply_action(nb, 1, int(r))) != -1, (a, r)


@pytest.mark.parametrize("greedy_player", [0, 1])
def test_greedy_beats_random(greedy_player):
    B, S = 64, 60
    gen = torch.Generator().manual_seed(0)
    state = tbc.reset_planes(B, CPU)
    greedy_sign = 1 if greedy_player == 0 else -1
    wins = {"greedy": 0, "random": 0}
    for _ in range(S):
        mask = tbc.legal_mask_planes(state.board, state.current)
        a_greedy = tg.greedy_actions(gen, state.board, state.current, 2)
        a_random = tbc.sample_random_lm(gen, mask)
        stepped = tbc.step_planes(
            state, torch.where(state.current == greedy_player, a_greedy, a_random))
        wins["greedy"] += int((stepped.winner == greedy_sign).sum())
        wins["random"] += int((stepped.winner == -greedy_sign).sum())
        state = tbc.autoreset_planes(stepped)
    total = wins["greedy"] + wins["random"]
    assert total > 0
    assert wins["greedy"] / total > 0.9, wins
