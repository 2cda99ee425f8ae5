"""The torch port's value search at play (twins of
``tests/test_value_search.py`` and of ``tests/test_zoo.py``'s conversion
test): with randomly initialised nets the proven scores must dominate the
learned values (immediate win, blocking a forced loss, the win in three),
every action is legal at both depths, and the zoo's search entrants play
full games; ``alphazero_gumbel32+search2`` converts the won opening
against the exact solver without MCTS.
"""

import numpy as np
import pytest
import torch

from gobblet_rl_torch import zoo
from gobblet_rl_torch.core import rules_np
from gobblet_rl_torch.eval import tournament
from gobblet_rl_torch.models import actor_critic as ac
from gobblet_rl_torch.models.mlp import QNet
from gobblet_rl_torch.native import engine
from gobblet_rl_torch.ops import batched_core as bc
from gobblet_rl_torch.policies import value_search as vs

CPU = torch.device("cpu")


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
def dqn_vf():
    net = QNet(hidden_sizes=(32, 32), device=CPU)
    net.reset_parameters(torch.Generator().manual_seed(0))
    return vs.dqn_value_fn(net)


@pytest.fixture(scope="module")
def az_vf():
    net = ac.MLPActorCritic(hidden_sizes=(32, 32), device=CPU)
    net.reset_parameters(torch.Generator().manual_seed(1))
    return vs.az_value_fn(net)


def _lm(*boards):
    return torch.from_numpy(np.stack(boards, axis=-1))


def _first_player():
    return torch.zeros(1, dtype=torch.int32)


def test_finds_immediate_win(dqn_vf):
    b = rules_np.empty_board()
    b = rules_np.apply_action(b, 0, 0)    # +1 at 0
    b = rules_np.apply_action(b, 1, 8)
    b = rules_np.apply_action(b, 0, 10)   # +2 at 1
    b = rules_np.apply_action(b, 1, 16)
    pol = vs.make_value_search(dqn_vf, depth=2)
    a = int(pol(torch.Generator().manual_seed(0), _lm(b), _first_player())[0])
    assert rules_np.line_winner(rules_np.apply_action(b, 0, a)) == 1, a


def test_blocks_forced_loss(az_vf):
    b = rules_np.empty_board()
    b = rules_np.apply_action(b, 1, 36)   # -5 at 0
    b = rules_np.apply_action(b, 1, 46)   # -6 at 1
    b = rules_np.apply_action(b, 0, 8)
    pol = vs.make_value_search(az_vf, depth=2)
    a = int(pol(torch.Generator().manual_seed(2), _lm(b), _first_player())[0])
    nb = rules_np.apply_action(b, 0, a)
    for r in np.nonzero(rules_np.legal_mask(nb, 1))[0]:
        assert rules_np.line_winner(rules_np.apply_action(nb, 1, int(r))) != -1, (a, r)


def test_converts_forced_win_in_three(dqn_vf):
    """The leaf solver makes three-ply forced wins exact.  P1 to move: +3@0,
    +4@2; P2 -6@1 (blocks row 0-1-2), -5@3.  A large piece at the centre
    threatens 8 (line 0-4-8) and 6 (line 2-4-6); P2 cannot gobble it and no
    single reply covers both."""
    b = rules_np.empty_board()
    b = rules_np.apply_action(b, 0, 18)   # +3 at 0
    b = rules_np.apply_action(b, 0, 29)   # +4 at 2
    b = rules_np.apply_action(b, 1, 46)   # -6 at 1
    b = rules_np.apply_action(b, 1, 39)   # -5 at 3
    for a in np.nonzero(rules_np.legal_mask(b, 0))[0]:   # no immediate win
        assert rules_np.line_winner(rules_np.apply_action(b, 0, int(a))) != 1

    pol = vs.make_value_search(dqn_vf, depth=2, solve_leaves=True)
    a = int(pol(torch.Generator().manual_seed(3), _lm(b), _first_player())[0])
    assert a in (36 + 4, 45 + 4), a       # +5@4 or +6@4
    nb = rules_np.apply_action(b, 0, a)
    for r in np.nonzero(rules_np.legal_mask(nb, 1))[0]:
        rb = rules_np.apply_action(nb, 1, int(r))
        if rules_np.line_winner(rb) != 0:
            continue
        wins = [w for w in np.nonzero(rules_np.legal_mask(rb, 0))[0]
                if rules_np.line_winner(rules_np.apply_action(rb, 0, int(w))) == 1]
        assert wins, r
    # the proven +2 is what finds it: without the leaf solver the candidate
    # scores stay on the learned band
    score = vs.search_scores(dqn_vf, _lm(b), _first_player(), 2, solve_leaves=True)
    assert float(score[a, 0]) == 2.0
    score = vs.search_scores(dqn_vf, _lm(b), _first_player(), 2, solve_leaves=False)
    assert float(score.max()) <= 1.0


@pytest.mark.parametrize("depth", [1, 2])
def test_actions_always_legal(az_vf, depth):
    B = 8
    state = bc.reset_planes(B, CPU)
    pol = vs.make_value_search(az_vf, depth=depth)
    gen = torch.Generator().manual_seed(0)
    for _ in range(10):
        mask = bc.legal_mask_planes(state.board, state.current)
        actions = pol(gen, state.board, state.current)
        assert mask[actions.long(), torch.arange(B)].all()
        state = bc.autoreset_planes(bc.step_planes(state, actions))


def test_zoo_dqn_search_entrant_runs():
    pol = vs.zoo_search_policy("dqn_greedy", device=CPU)
    state = bc.reset_planes(4, CPU)
    gen = torch.Generator().manual_seed(0)
    for _ in range(12):
        state = bc.autoreset_planes(bc.step_planes(state, pol(gen, state.board, state.current)))
    assert int(state.turn.sum()) > 0


def test_az_value_search_converts_without_mcts():
    """``alphazero_gumbel32``'s value head at depth 2 with the leaf solver,
    no MCTS, converts the won opening against perfect defense."""
    assert zoo.meta("alphazero_gumbel32")["family"] == "alphazero"
    res = tournament.play_match(vs.zoo_search_policy("alphazero_gumbel32", device=CPU),
                                tournament.solver_policy(depth=15), num_games=8, seed=0,
                                swap_colors=False, max_plies=60, device=CPU)
    engine.solve_tt_clear()
    assert res["losses"] == 0 and res["win_rate"] >= 0.85, res

