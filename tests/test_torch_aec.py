"""The torch port's host surface (gobblet_v1, env/aec.py, board.py,
render/, policies/greedy.py) against the JAX package's, on the CPU.

Twins of ``tests/test_env_api.py`` (PettingZoo's ``api_test`` and
``seed_test``, resets, renders, the illegal-move termination) and of
``tests/test_render_golden.py`` (the committed golden frames under that
file's pixel budget), plus lockstep games: the port's env and JAX's,
driven by one random-admissible action stream, must give equal
observations, masks, rewards, terminations, truncations and agent order at
every step, and byte-equal ``text``/``text_full`` renders.  The host greedy
gives JAX's actions on the same observations and global numpy seed.
"""

import contextlib
import io
import os

import numpy as np
import pettingzoo.test
import pytest

from gobblet_rl_torch import gobblet_v1
from gobblet_rl_torch.board import Board
from gobblet_rl_torch.policies import greedy as tgreedy
from gobblet_rl_tpu import gobblet_v1 as jgobblet_v1
from gobblet_rl_tpu.board import Board as JBoard
from gobblet_rl_tpu.policies import greedy as jgreedy

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
SCRIPT = [36, 53, 30, 25, 2]   # tests/test_render_golden.py's midgame


@pytest.fixture(scope="function")
def env():
    e = gobblet_v1.raw_env(render_mode=None)
    e.reset()
    yield e
    e.close()


def test_reset(env):
    env.reset()
    assert env.agent_selection == "player_1" and env.turn == 0 and env.action == -1


def test_reset_starting(env):
    assert (env.board.squares == np.zeros(27)).all()


def test_api(env):
    pettingzoo.test.api_test(env, num_cycles=10, verbose_progress=False)


def test_seed():
    pettingzoo.test.seed_test(gobblet_v1.env)


def test_seed_raw():
    pettingzoo.test.seed_test(gobblet_v1.raw_env)


def test_render_text(capsys):
    e = gobblet_v1.raw_env(render_mode="text")
    e.reset()
    e.step(0)
    out = capsys.readouterr().out
    assert "TURN: 1, AGENT: player_2, ACTION: 0, POSITION: 0, PIECE: 1" in out
    e.close()


def test_render_rgb_array():
    e = gobblet_v1.raw_env(render_mode="rgb_array")
    e.reset()
    e.step(0)
    frame = e.render()
    assert frame.shape == (640, 640, 3) and frame.dtype == np.uint8
    e.close()


def test_illegal_action_terminates_wrapped():
    e = gobblet_v1.env(render_mode=None)
    e.reset()
    e.step(0)   # p1 small @0
    e.step(0)   # p2: illegal (same size on an occupied cell)
    assert all(e.terminations.values())
    assert e.rewards["player_2"] == -1 and e.rewards["player_1"] == 0
    e.close()


def _step_both(ours, theirs, action, capture):
    if not capture:
        ours.step(action)
        theirs.step(action)
        return
    a, b = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(a):
        ours.step(action)
    with contextlib.redirect_stdout(b):
        theirs.step(action)
    assert a.getvalue() == b.getvalue()
    assert a.getvalue() or action is None   # a dead step renders nothing


def _drive_pair(ours, theirs, seed, max_plies=60, capture=False, illegal_every=0):
    """Both envs on one action stream; every ``illegal_every``-th move is
    arbitrary (often illegal).  Returns the number of steps taken."""
    rng = np.random.default_rng(seed)
    ours.reset()
    theirs.reset()
    for ply in range(max_plies):
        got, want = ours.last(), theirs.last()
        np.testing.assert_array_equal(got[0]["observation"], want[0]["observation"])
        np.testing.assert_array_equal(got[0]["action_mask"], want[0]["action_mask"])
        assert got[0]["observation"].dtype == want[0]["observation"].dtype == np.int8
        assert got[1:4] == want[1:4]
        assert ours.agent_selection == theirs.agent_selection
        assert ours.agents == theirs.agents and ours.rewards == theirs.rewards
        if got[2] or got[3]:
            _step_both(ours, theirs, None, capture)
            if not theirs.agents:
                assert not ours.agents
                return ply
            continue
        if illegal_every and ply % illegal_every == illegal_every - 1:
            action = int(rng.integers(0, 54))
        else:
            action = int(rng.choice(np.nonzero(want[0]["action_mask"])[0]))
        _step_both(ours, theirs, action, capture)
    return max_plies


@pytest.mark.parametrize("seed", range(5))
def test_lockstep_parity_vs_jax(seed):
    steps = _drive_pair(gobblet_v1.env(render_mode=None), jgobblet_v1.env(render_mode=None),
                        seed)
    assert steps > 4


@pytest.mark.parametrize("seed", range(3))
def test_wrapped_env_terminates_illegal_as_jax(seed):
    _drive_pair(gobblet_v1.env(render_mode=None), jgobblet_v1.env(render_mode=None), seed,
                illegal_every=3)


def test_raw_env_illegal_moves_pass_the_turn_as_jax():
    """The raw env makes an illegal move a no-op that passes the turn."""
    ours, theirs = gobblet_v1.raw_env(), jgobblet_v1.raw_env()
    for seed in range(3):
        _drive_pair(ours, theirs, seed, max_plies=40, illegal_every=2)
        np.testing.assert_array_equal(ours.board.squares, theirs.board.squares)


@pytest.mark.parametrize("mode", ["text", "text_full"])
def test_text_render_byte_parity(mode):
    _drive_pair(gobblet_v1.env(render_mode=mode), jgobblet_v1.env(render_mode=mode), seed=11,
                capture=True)


def _check_golden(name: str, frame: np.ndarray) -> None:
    """tests/test_render_golden.py's check, without its regeneration mode."""
    from PIL import Image

    golden = np.asarray(Image.open(os.path.join(GOLDEN_DIR, name)))
    assert frame.shape == golden.shape, (frame.shape, golden.shape)
    mismatch = int((frame != golden).any(axis=-1).sum())
    budget = int(frame.shape[0] * frame.shape[1] * 0.002)
    assert mismatch <= budget, f"{name}: {mismatch} pixels differ from golden (budget {budget})"


def test_env_rgb_array_matches_golden():
    pytest.importorskip("pygame")
    frames = []
    for module in (gobblet_v1, jgobblet_v1):
        e = module.env(render_mode="rgb_array")
        e.reset(seed=0)
        for i, a in enumerate(SCRIPT):
            obs, *_ = e.last()
            assert obs["action_mask"][a] == 1, (i, a)
            e.step(a)
        frames.append(np.asarray(e.render()))
        e.close()
    assert frames[0].shape == (640, 640, 3) and frames[0].dtype == np.uint8
    _check_golden("env_midgame.png", frames[0])
    np.testing.assert_array_equal(frames[0], frames[1])


def test_preview_frame_matches_golden_and_is_translucent():
    pygame = pytest.importorskip("pygame")
    from gobblet_rl_torch.render import surface as surface_render

    pygame.init()
    width = 297
    screen = pygame.Surface((width, width))
    squares = np.zeros(27, np.int8)
    squares[18 + 0] = 5          # red big at cell 0
    preview = np.zeros(27, np.int8)
    preview[18 + 4] = 6          # red big hover preview at the centre
    preview[9 + 8] = -3          # yellow medium preview at cell 8
    surface_render.draw_board(screen, squares, preview, width)
    frame = surface_render.surface_to_rgb_array(screen)
    cx, cy = surface_render._cell_center(4, width)
    px = frame[cy, cx]
    assert not np.array_equal(px, surface_render.RED)
    assert not np.array_equal(px, surface_render.BACKGROUND)
    lo = np.minimum(surface_render.RED, surface_render.BACKGROUND)
    hi = np.maximum(surface_render.RED, surface_render.BACKGROUND)
    assert ((lo <= px) & (px <= hi)).all(), px
    _check_golden("preview.png", frame)


@pytest.mark.parametrize("depth,games,plies,opening", [(1, 3, 40, 0), (2, 3, 40, 0),
                                                       (3, 2, 2, 6)])
def test_greedy_policy_equals_jax(depth, games, plies, opening):
    """Both host greedies pick for both seats on the observations of one
    game, from the same global numpy seed, and must agree every move.  The
    depth-3 scan takes seconds a move in Python (either package), so it
    plays two moves from a position ``opening`` random plies deep."""
    e = gobblet_v1.env(render_mode=None)
    ours = tgreedy.GreedyGobbletPolicy(depth=depth)
    theirs = jgreedy.GreedyGobbletPolicy(depth=depth)
    rng = np.random.default_rng(depth)
    moves = 0
    for game in range(games):
        e.reset()
        for _ in range(opening):
            obs, _, term, trunc, _ = e.last()
            if not (term or trunc):
                e.step(int(rng.choice(np.nonzero(obs["action_mask"])[0])))
        for ply in range(plies):
            obs, _, term, trunc, _ = e.last()
            if term or trunc:
                break
            np.random.seed(100 * game + ply)
            a = ours.compute_action(obs["observation"], obs["action_mask"])
            np.random.seed(100 * game + ply)
            b = theirs.compute_action(obs["observation"], obs["action_mask"])
            assert int(a) == int(b), (game, ply)
            grid, idx = tgreedy.board_from_observation(obs["observation"])
            jgrid, jidx = jgreedy.board_from_observation(obs["observation"])
            np.testing.assert_array_equal(grid, jgrid)
            assert idx == jidx and grid.dtype == jgrid.dtype
            e.step(int(a))
            moves += 1
    assert moves >= 2 * games
    assert ours.prev_actions == theirs.prev_actions


def test_board_facade_equals_jax():
    ours, theirs = Board(), JBoard()
    rng = np.random.default_rng(0)
    for ply in range(20):
        player = ply % 2
        action = int(rng.integers(0, 54))
        assert ours.is_legal(action, player) == theirs.is_legal(action, player)
        assert ours.get_action(action % 9, 1 + action % 3, player) == \
            theirs.get_action(action % 9, 1 + action % 3, player)
        ours.play_turn(player, action)
        theirs.play_turn(player, action)
        np.testing.assert_array_equal(ours.squares, theirs.squares)
        np.testing.assert_array_equal(ours.get_flatboard(), theirs.get_flatboard())
        np.testing.assert_array_equal(ours.check_covered(), theirs.check_covered())
        assert ours.check_for_winner() == theirs.check_for_winner()
    assert ours.winning_combinations == theirs.winning_combinations


def test_manual_policy_is_not_ported_yet():
    """Ported since: ``ManualGobbletPolicy`` is the lazy attribute of JAX's
    ``gobblet_v1``, the policy of ``interactive/manual_policy.py``."""
    from gobblet_rl_torch.interactive.manual_policy import ManualGobbletPolicy

    assert gobblet_v1.ManualGobbletPolicy is ManualGobbletPolicy
    assert {"GreedyGobbletPolicy", "ManualGobbletPolicy"} <= set(gobblet_v1.__all__)
    with pytest.raises(AttributeError):
        gobblet_v1.NoSuchPolicy
