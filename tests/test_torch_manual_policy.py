"""The torch port's manual policy (``interactive/manual_policy.py``) driven by
synthetic pygame events, on the port's AEC env.

Twins of the seven tests of ``tests/test_manual_policy.py``: scripted
(event, mouse-position) pairs feed the ``pygame.event.wait`` loop under the
dummy SDL driver, and the returned action, the pick-up action-mask rewrite
and the hover preview written to ``board.squares_preview`` take the values
pinned there (tolerance 0).  A lockstep test runs one script through the
port's policy and JAX's, on the two packages' envs, and compares every
frame's preview, the action and the rewritten mask.
"""


from collections import deque

import numpy as np
import pytest
import torch

pygame = pytest.importorskip("pygame")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes on a few cores, where torch's thread pools would oversubscribe
    them and small ops slow down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# cell = axis_band(mousey) + 3 * axis_band(mousex); band centers for a
# 640x640 window (thresholds at 0.36 and 0.64 of the extent)
_BAND_CENTER = [100, 320, 500]


def pixel_for_cell(cell: int) -> tuple[int, int]:
    return _BAND_CENTER[cell // 3], _BAND_CENTER[cell % 3]


class ScriptedIO:
    """Feeds the policy loop one (event, mouse-pos) pair per iteration."""

    def __init__(self, script):
        self.script = deque(script)
        self.pos = (0, 0)

    def wait(self):
        if not self.script:
            raise AssertionError("manual policy consumed more events than scripted")
        event, cell = self.script.popleft()
        if cell is not None:
            self.pos = pixel_for_cell(cell)
        return event

    def get_pos(self):
        return self.pos


def click(cell):
    return (pygame.event.Event(pygame.MOUSEBUTTONDOWN, {}), cell)


def motion(cell):
    return (pygame.event.Event(pygame.MOUSEMOTION, {}), cell)


def key(k):
    return (pygame.event.Event(pygame.KEYDOWN, {"key": k}), None)


@pytest.fixture()
def manual_env(monkeypatch):
    """Wrapped human-mode env + a factory for a scripted ManualGobbletPolicy."""
    from gobblet_rl_torch import gobblet_v1

    env = gobblet_v1.env(render_mode="human")
    env.reset()

    def make_policy(script, agent_id=0):
        from gobblet_rl_torch.interactive.manual_policy import ManualGobbletPolicy

        policy = ManualGobbletPolicy(env, agent_id)  # real render opens window
        io = ScriptedIO(script)
        monkeypatch.setattr(pygame.event, "wait", io.wait)
        monkeypatch.setattr(pygame.mouse, "get_pos", io.get_pos)
        return policy, io

    yield env, make_policy
    env.close()


def test_place_default_piece(manual_env):
    """No key pressed: the default piece is the largest unplaced (6, size 3);
    clicking an empty cell returns pos + 9*(piece-1)."""
    env, make_policy = manual_env
    policy, _ = make_policy([click(4)])
    action = policy(env.observe("player_1"), "player_1")
    assert int(action) == 4 + 9 * 5  # piece 6 at center


def test_key_selects_size_then_place(manual_env):
    """Key '1' selects the small pieces (piece 1 first)."""
    env, make_policy = manual_env
    policy, _ = make_policy([key(pygame.K_1), click(0)])
    action = policy(env.observe("player_1"), "player_1")
    assert int(action) == 0  # piece 1 at pos 0


def test_space_cycles_to_medium(manual_env):
    """One SPACE press from the initial state selects size 2 (piece 3):
    cycle index (max_size - (cycle+1)) % len = (3-2) % 3 = 1."""
    env, make_policy = manual_env
    policy, _ = make_policy([key(pygame.K_SPACE), click(8)])
    action = policy(env.observe("player_1"), "player_1")
    assert int(action) == 8 + 9 * 2  # piece 3 at pos 8


def test_hover_preview_written_and_cleared(manual_env):
    """Hovering a legal cell writes agent-signed preview at that cell's
    level; the placing click clears it (manual_policy.py:156-172)."""
    env, make_policy = manual_env
    policy, _ = make_policy([motion(2), click(4)])

    previews = []
    raw = env.unwrapped
    orig_render = raw.render
    raw.render = lambda: previews.append(np.array(raw.board.squares_preview))
    try:
        action = policy(env.observe("player_1"), "player_1")
    finally:
        raw.render = orig_render
    assert int(action) == 4 + 9 * 5
    # iteration 1: hover over cell 2 with piece 6 (level 2) -> preview +1
    assert previews[0][2 + 9 * 2] == 1
    assert previews[0].sum() == 1
    # the returned click zeroes its own preview cell before returning
    assert raw.board.squares_preview[4 + 9 * 2] == 0


def test_pickup_rewrites_mask_and_moves_piece(manual_env):
    """Clicking an own top piece lifts it off the board and rewrites the
    action mask to only that piece's moves; the second click places it
    (gobbling the opponent's smaller piece)."""
    env, make_policy = manual_env
    env.step(49)  # player_1: piece 6 (large) at pos 4
    env.step(0)   # player_2: piece 1 (small) at pos 0

    obs = env.observe("player_1")
    assert obs["action_mask"][45:54].any()
    policy, _ = make_policy([click(4), click(0)])
    action = policy(obs, "player_1")
    assert int(action) == 0 + 9 * 5  # piece 6 moved to pos 0

    # mask rewrite: only piece-6 rows stay, and its origin cell is excluded
    assert not obs["action_mask"][: 9 * 5].any()
    assert obs["action_mask"][49] == 0
    # pick-up physically lifted the piece (reference mutates board.squares)
    board = env.unwrapped.board
    assert not (np.asarray(board.squares) == 6).any()

    # completing the move through the env gobbles the opponent's piece
    env.step(int(action))
    flat = board.get_flatboard()
    assert flat[0] == 6


def test_pickup_respects_covered_piece(manual_env):
    """A covered piece can't be picked up: its move rows are all illegal, so
    the click is a no-op and a later legal placement still works."""
    env, make_policy = manual_env
    env.step(18)  # player_1: medium piece 3 at pos 0
    env.step(36)  # player_2: large piece 5 covers pos 0

    obs = env.observe("player_1")
    # piece-3 moves are all illegal while covered (golden mask, test_rules)
    assert not obs["action_mask"][18:27].any()
    policy, _ = make_policy([click(0), click(4)])
    action = policy(obs, "player_1")
    # click(0): flat[0] is the opponent's piece -> not a pick-up; with the
    # default piece 6 selected the click on pos 0 would gobble... but pos 0
    # holds a LARGE opponent piece, so it is illegal and ignored;
    # click(4) places piece 6 at the empty center instead.
    assert int(action) == 4 + 9 * 5


def test_quit_event_exits(manual_env):
    env, make_policy = manual_env
    policy, _ = make_policy([(pygame.event.Event(pygame.QUIT, {}), None)])
    with pytest.raises(SystemExit):
        policy(env.observe("player_1"), "player_1")
    # pygame.quit() ran; re-init so the fixture's env.close() stays happy
    pygame.init()


def test_manual_policy_lockstep_with_jax(monkeypatch):
    """One script (size keys, SPACE, hovers, a pick-up and a placement)
    through the port's policy and JAX's, each on its own package's env
    after the same opening: equal previews frame by frame, equal action,
    equal rewritten mask, equal board after the move."""
    from gobblet_rl_torch import gobblet_v1 as tv1
    from gobblet_rl_torch.interactive.manual_policy import ManualGobbletPolicy as TManual
    from gobblet_rl_tpu import gobblet_v1 as jv1
    from gobblet_rl_tpu.interactive.manual_policy import ManualGobbletPolicy as JManual

    script = [key(pygame.K_2), motion(3), key(pygame.K_SPACE), motion(5), key(pygame.K_3),
              motion(2), click(4), motion(1), motion(8), click(0)]
    results = []
    for v1, Manual in ((tv1, TManual), (jv1, JManual)):
        env = v1.env(render_mode="human")
        env.reset()
        for a in (49, 0, 20, 44):        # P1 large@4, P2 small@0, P1 medium@2, P2 large@8
            env.step(a)
        policy = Manual(env, 0)
        io = ScriptedIO(script)
        monkeypatch.setattr(pygame.event, "wait", io.wait)
        monkeypatch.setattr(pygame.mouse, "get_pos", io.get_pos)
        previews = []
        raw = env.unwrapped
        raw.render = lambda raw=raw: previews.append(np.array(raw.board.squares_preview))
        obs = env.observe("player_1")
        action = int(policy(obs, "player_1"))
        mask = np.array(obs["action_mask"])
        del raw.render
        env.step(action)
        results.append((action, mask, previews, np.array(raw.board.squares)))
        env.close()
        pygame.init()
    (ta, tmask, tprev, tboard), (ja, jmask, jprev, jboard) = results
    assert ta == ja == 0 + 9 * 5            # the lifted large piece gobbles cell 0
    assert not tmask[:45].any()             # the pick-up rewrote the mask
    assert sum(bool(p.any()) for p in tprev) >= 3
    np.testing.assert_array_equal(tmask, jmask)
    assert len(tprev) == len(jprev) == len(script)
    for t, j in zip(tprev, jprev):
        np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(tboard, jboard)
