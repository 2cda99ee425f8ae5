"""The torch port's framework adapters and ``GameSession`` on the port's AEC
env, under the vendored API stubs of ``tests/framework_stubs.py`` (neither
tianshou nor ray is installed here).

Twins of ``tests/test_adapters.py``: the reference's scripted 5-ply drive
through the tianshou ``ManualPolicyCollector`` adapter, the framework-free
``GameSession`` and the wrapped env, with the same golden masks, legal-move
list, board and illegal-move semantics (the offender's reward -1, the board
unchanged, one finished episode), and the rllib policies.  The greedy
adapters give the port's host greedy's actions, which are JAX's.
"""


import sys

import numpy as np
import pytest
import torch

from . import framework_stubs as stubs

ADAPTERS = ("gobblet_rl_torch.adapters.tianshou_adapter", "gobblet_rl_torch.adapters.rllib_adapter")


def uninstall():
    """Remove the stubs and the port's adapters imported under them, so
    the import-gating test sees the frameworks absent again."""
    stubs.uninstall_stubs()
    for name in ADAPTERS:
        sys.modules.pop(name, None)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes on a few cores, where torch's thread pools would oversubscribe
    them and small ops slow down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

GOLDEN_SCRIPT = [18, 36, 28, 46]  # P1 medium@0, P2 covers, P1 medium@1, P2 covers


def golden_masks():
    """Expected 54-masks after each scripted ply (reference test :109-377)."""
    m1 = np.ones(54, bool)
    m1[[0, 9, 18, 27]] = False
    m2 = np.ones(54, bool)
    m2[[0, 9]] = False
    m2[18:28] = False
    m2[[36, 45]] = False
    m3 = np.ones(54, bool)
    m3[[0, 1, 9, 10, 18, 19, 27, 28, 36, 45]] = False
    m4 = np.zeros(54, bool)
    m4[[2, 3, 4, 5, 6, 7, 8, 11, 12, 13, 14, 15, 16, 17,
        38, 39, 40, 41, 42, 43, 44, 47, 48, 49, 50, 51, 52, 53]] = True
    return [m1, m2, m3, m4]


GOLDEN_BOARD = np.array(
    [
        [[0, 0, 0], [0, 0, 0], [0, 0, 0]],
        [[3, 4, 0], [0, 0, 0], [0, 0, 0]],
        [[-5, -6, 0], [0, 0, 0], [0, 0, 0]],
    ]
)


@pytest.fixture()
def tianshou_stub():
    stubs.install_tianshou_stub()
    yield
    uninstall()


@pytest.fixture()
def rllib_stub():
    stubs.install_rllib_stub()
    yield
    uninstall()


def _make_venv():
    from gobblet_rl_torch import gobblet_v1

    return stubs.DummyVectorEnvLike(
        [lambda: stubs.PettingZooEnvLike(gobblet_v1.env(render_mode=None))]
    )


# --------------------------------------------------------------------------
# tianshou adapter
# --------------------------------------------------------------------------
def test_manual_policy_collector_golden_script(tianshou_stub):
    from gobblet_rl_torch.adapters.tianshou_adapter import (
        GreedyPolicy,
        ManualPolicyCollector,
    )

    venv = _make_venv()
    collector = ManualPolicyCollector(
        GreedyPolicy(depth=1), venv, exploration_noise=True
    )
    # start: every action legal (reference output0)
    assert collector.data.obs.mask.shape == (1, 54)
    assert collector.data.obs.mask.all()

    for action, expected in zip(GOLDEN_SCRIPT, golden_masks()):
        result = collector.collect_result(np.array(action).reshape(1))
        assert result["n/ep"] == 0 and result["n/st"] == 1
        np.testing.assert_array_equal(collector.data.obs.mask[0], expected)

    # exact legal-move list after the covering plies (reference :385-417)
    legal = venv.workers[0].env.env.unwrapped._legal_moves()
    assert legal == [2, 3, 4, 5, 6, 7, 8, 11, 12, 13, 14, 15, 16, 17,
                     38, 39, 40, 41, 42, 43, 44, 47, 48, 49, 50, 51, 52, 53]

    # illegal ply: live-reference semantics — terminate, offender rewarded -1
    result = collector.collect_result(np.array(29).reshape(1))
    assert result["n/ep"] == 1
    assert result["rews"].tolist() == [-1.0]
    assert result["lens"].tolist() == [5]
    # collector auto-reset: fresh all-legal mask
    assert collector.data.obs.mask.all()
    assert len(collector.buffer.added) == 5


def test_greedy_policy_forward_matches_core(tianshou_stub):
    from gobblet_rl_torch.adapters.tianshou_adapter import GreedyPolicy
    from gobblet_rl_torch.policies.greedy import GreedyGobbletPolicy

    venv = _make_venv()
    obs = venv.reset()
    for action in GOLDEN_SCRIPT:
        obs, *_ = venv.step(np.array([action]))

    batch = stubs.Batch(obs=stubs.Batch(obs=obs.obs, mask=obs.mask))
    for depth in (1, 2):
        np.random.seed(123)
        adapter_act = GreedyPolicy(depth=depth).forward(batch).act
        np.random.seed(123)
        direct = GreedyGobbletPolicy(depth=depth).compute_action(
            obs.obs[0], obs.mask[0]
        )
        assert adapter_act.shape == (1,)
        assert int(adapter_act[0]) == int(direct)
        # chosen action must be legal
        assert obs.mask[0][int(adapter_act[0])]


def test_greedy_policy_forward_unbatched_input(tianshou_stub):
    """A single (3,3,13) observation row is promoted to a batch of one."""
    from gobblet_rl_torch.adapters.tianshou_adapter import GreedyPolicy

    venv = _make_venv()
    obs = venv.reset()
    batch = stubs.Batch(obs=stubs.Batch(obs=obs.obs[0], mask=obs.mask[0]))
    np.random.seed(7)
    out = GreedyPolicy(depth=1).forward(batch)
    assert out.act.shape == (1,)
    assert obs.mask[0][int(out.act[0])]


def test_greedy_policy_learn_is_noop(tianshou_stub):
    from gobblet_rl_torch.adapters.tianshou_adapter import GreedyPolicy

    assert GreedyPolicy(depth=1).learn(stubs.Batch()) == {}


def test_collector_collect_drives_greedy_turn(tianshou_stub):
    """collect(n_step=1) routes policy.forward -> env.step -> buffer.add
    (the CPU-turn path of the reference play loop,
    example_tianshou_DQN.py:574)."""
    from gobblet_rl_torch.adapters.tianshou_adapter import (
        GreedyPolicy,
        ManualPolicyCollector,
    )

    np.random.seed(5)
    venv = _make_venv()
    collector = ManualPolicyCollector(GreedyPolicy(depth=1), venv)
    mask_before = collector.data.obs.mask.copy()
    assert mask_before.all()
    collector.collect(n_step=1)
    assert len(collector.buffer.added) == 1
    act = int(collector.buffer.added[0]["act"][0])
    assert 0 <= act < 54
    # one piece is now on the board: the new mask is strictly smaller
    assert collector.data.obs.mask.sum() < mask_before.sum()


# --------------------------------------------------------------------------
# rllib adapters
# --------------------------------------------------------------------------
def test_rllib_greedy_policy(rllib_stub):
    from gobblet_rl_torch.adapters.rllib_adapter import GreedyPolicy

    venv = _make_venv()
    obs = venv.reset()
    for action in GOLDEN_SCRIPT:
        obs, *_ = venv.step(np.array([action]))
    policy = GreedyPolicy()
    obs_batch = {
        "observation": obs.obs.reshape(1, -1),
        "action_mask": obs.mask,
    }
    actions, state, info = policy.compute_actions(obs_batch)
    assert state == [] and info == {}
    assert len(actions) == 1
    assert obs.mask[0][int(actions[0])]


def test_rllib_random_admissible_policy(rllib_stub):
    from gobblet_rl_torch.adapters.rllib_adapter import RandomAdmissiblePolicy

    np.random.seed(0)
    masks = np.zeros((4, 54))
    legal_cols = [3, 17, 29, 53]
    for i, c in enumerate(legal_cols):
        masks[i, c] = 1
    policy = RandomAdmissiblePolicy()
    actions, state, info = policy.compute_actions({"action_mask": masks})
    assert actions == legal_cols  # single legal action per row is forced


# --------------------------------------------------------------------------
# GameSession: same scripted drive through the framework-free stack
# --------------------------------------------------------------------------
def test_game_session_golden_script():
    from gobblet_rl_torch import gobblet_v1
    from gobblet_rl_torch.interactive.session import GameSession

    session = GameSession(gobblet_v1.env(render_mode=None))
    assert session.observation()["action_mask"].all()

    for action, expected in zip(GOLDEN_SCRIPT, golden_masks()):
        result = session.collect_result(np.array(action))
        assert result["n/ep"] == 0 and result["n/st"] == 1
        np.testing.assert_array_equal(
            session.observation()["action_mask"].astype(bool), expected
        )

    result = session.collect_result(np.array(29))  # illegal -> terminate
    assert result["n/ep"] == 1
    assert result["rews"].tolist() == [-1.0]
    assert session.episode_lengths == [5]
    # auto-reset happened
    assert session.observation()["action_mask"].all()


def test_wrapped_env_illegal_move_semantics():
    """Board tensor preserved + terminate-with--1, as measured on the live
    reference env (reference test :498-507 pins the same board)."""
    from gobblet_rl_torch import gobblet_v1

    env = gobblet_v1.env(render_mode=None)
    env.reset()
    for action in GOLDEN_SCRIPT:
        env.step(action)
    env.step(29)
    assert all(env.terminations.values())
    assert env.unwrapped.rewards == {"player_1": -1, "player_2": 0}
    np.testing.assert_array_equal(
        np.asarray(env.unwrapped.board.squares).reshape(3, 3, 3), GOLDEN_BOARD
    )


@pytest.mark.parametrize("module,message", [
    ("gobblet_rl_torch.adapters.tianshou_adapter", "tianshou is not installed"),
    ("gobblet_rl_torch.adapters.rllib_adapter", r"ray\[rllib\] is not installed"),
])
def test_adapters_raise_cleanly_without_frameworks(module, message):
    """Twin of ``tests/test_examples.py``'s import-gating test, for both
    adapters: without the framework the import raises JAX's message."""
    import importlib

    framework = module.split(".")[-1].split("_")[0]
    try:
        importlib.import_module("tianshou" if framework == "tianshou" else "ray.rllib")
        pytest.fail(f"{framework} is installed here; this test expects it absent")
    except ImportError:
        pass
    sys.modules.pop(module, None)
    with pytest.raises(ImportError, match=message):
        importlib.import_module(module)


def test_game_session_equals_jax_on_a_played_game():
    """``GameSession.collect`` with the host greedy on both seats, against
    JAX's session on JAX's env, from one global numpy seed: the same
    actions, stats dicts, episode rewards and lengths; the session resets
    itself at the game's end."""
    from gobblet_rl_torch import gobblet_v1
    from gobblet_rl_torch.interactive.session import GameSession
    from gobblet_rl_torch.policies import GreedyGobbletPolicy
    from gobblet_rl_tpu import gobblet_v1 as jgobblet_v1
    from gobblet_rl_tpu.interactive.session import GameSession as JGameSession
    from gobblet_rl_tpu.policies import GreedyGobbletPolicy as JGreedy

    runs = []
    for v1, Session, Greedy in ((gobblet_v1, GameSession, GreedyGobbletPolicy),
                                (jgobblet_v1, JGameSession, JGreedy)):
        np.random.seed(21)
        session = Session(v1.env(render_mode=None),
                          {a: Greedy(depth=1) for a in ("player_1", "player_2")})
        results = []
        while len(session.episode_rewards) < 2:
            results.append(session.collect(n_step=1))
        runs.append((results, session.episode_rewards, session.episode_lengths,
                     session.observation()["action_mask"]))
    (tres, trew, tlen, tmask), (jres, jrew, jlen, jmask) = runs
    assert trew == jrew and tlen == jlen and len(tres) == len(jres) == sum(tlen)
    for t, j in zip(tres, jres):
        assert set(t) == set(j)
        for k in t:
            np.testing.assert_array_equal(t[k], j[k])
            assert np.asarray(t[k]).dtype == np.asarray(j[k]).dtype, k
    assert tmask.all() and jmask.all()       # both reset after the second game
