"""The torch port's host command lines without a net, the play modes, the
GIF recorder, the session's stats and the utilities, on the CPU.

Twins of ``tests/test_examples.py`` (``example_basic``, the
``example_greedy`` watch, the GIF recorder, the session's stats dict,
``example_user_input --cpu-players 2``) and of
``tests/test_aux_subsystems.py``'s throughput meter.  Where the seed fixes
the output, the port's transcript (or final board) equals JAX's byte for
byte: the random policy and the host greedy draw as JAX's.  The human seat
of the play modes is a stand-in policy that plays the lowest legal action.
The watches of the net agents are in ``tests/test_torch_host_watch.py``.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes on a few cores, where torch's thread pools would oversubscribe
    them and small ops slow down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def transcript(fn, *args, **kwargs) -> str:
    """``fn``'s standard output, from a fixed global numpy seed (the host
    greedy's fallback draws from it)."""
    np.random.seed(0)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args, **kwargs)
    return out.getvalue()


@pytest.mark.parametrize("seed", [1, 8])
def test_example_basic_transcript_equals_jax(seed):
    from gobblet_rl_torch.examples import example_basic as t
    from gobblet_rl_tpu.examples import example_basic as j

    argv = ["--render_mode", "text", "--seed", str(seed)]
    out = transcript(t.main, t.build_parser().parse_args(argv))
    assert "TURN: 1" in out and "Reward" in out
    assert out == transcript(j.main, j.build_parser().parse_args(argv))


def test_example_greedy_watch_transcript_equals_jax():
    from gobblet_rl_torch.examples import example_greedy as t
    from gobblet_rl_tpu.examples import example_greedy as j

    argv = ["--render_mode", "text", "--seed", "2", "--depth", "1"]
    out = transcript(t.main, t.get_parser().parse_args(argv))
    assert "Final rewards" in out
    assert out == transcript(j.main, j.get_parser().parse_args(argv))


class FirstLegal:
    """Stand-in for the human at the mouse: the lowest legal action."""

    def __init__(self, env, agent_id=0, recorder=None):
        self.env, self.recorder = env, recorder
        env.render()

    def __call__(self, observation, agent):
        return np.int32(np.flatnonzero(observation["action_mask"])[0])


@pytest.mark.parametrize("cpu_policy", ["random", "greedy", "alphabeta"])
def test_example_user_input_cpu_only_equals_jax(cpu_policy, monkeypatch):
    """``--cpu-players 2`` plays itself (the human-mode window opens under
    the dummy SDL driver); the final board and rewards equal JAX's."""
    from gobblet_rl_torch import gobblet_v1
    from gobblet_rl_torch.examples import example_user_input as t
    from gobblet_rl_tpu import gobblet_v1 as jgobblet_v1
    from gobblet_rl_tpu.examples import example_user_input as j

    finals = []
    for v1, mod in ((gobblet_v1, t), (jgobblet_v1, j)):
        made = []
        real_env = v1.env
        monkeypatch.setattr(v1, "env", lambda *a, **k: made.append(real_env(*a, **k)) or made[-1])
        mod.main(mod.get_parser().parse_args(["--cpu-players", "2", "--cpu-policy", cpu_policy,
                                              "--seed", "5"]))
        raw = made[0].unwrapped
        finals.append((np.array(raw.board.squares), dict(raw._cumulative_rewards), raw.turn))
        made[0].close()
    (tb, tr, tt), (jb, jr, jt) = finals
    np.testing.assert_array_equal(tb, jb)
    assert tr == jr and tt == jt and tt > 0


@pytest.mark.parametrize("module,argv", [
    ("example_dqn", ["--cpu-players", "1", "--record", "--device", "cpu", "--zoo", "dqn_greedy"]),
    ("example_greedy", ["--cpu-players", "1", "--record", "--depth", "1"]),
    ("example_record_game", ["--out", "{gif}"]),
])
def test_play_modes_record_a_gif(module, argv, tmp_path, monkeypatch):
    """The human-vs-CPU loops of the DQN and greedy CLIs and the recording
    CLI run a whole game with the stand-in human and write a GIF."""
    import importlib

    from PIL import Image

    from gobblet_rl_torch import gobblet_v1

    monkeypatch.setattr(gobblet_v1, "ManualGobbletPolicy", FirstLegal, raising=False)
    monkeypatch.chdir(tmp_path)
    gif = tmp_path / "game.gif"
    mod = importlib.import_module(f"gobblet_rl_torch.examples.{module}")
    parser = mod.get_parser()
    mod.main(parser.parse_args([a.format(gif=gif) for a in argv]))
    img = Image.open(gif)
    assert img.format == "GIF" and img.size == (640, 640)
    img.seek(img.n_frames - 1)


def test_gif_recorder(tmp_path):
    from PIL import Image

    from gobblet_rl_torch.render.gif import GIFRecorder

    out = str(tmp_path / "test.gif")
    rec = GIFRecorder(out_file=out)
    for i in range(5):
        rec.capture_frame(np.full((64, 64, 3), i * 40, np.uint8))
    rec.end_recording()
    assert os.path.exists(out) and rec.ended
    img = Image.open(out)
    assert img.format == "GIF"
    img.seek(4)  # at least 5 frames
    rec.capture_frame(np.zeros((64, 64, 3), np.uint8))     # ignored once ended
    assert rec.frame_num == 5


def test_gif_recorder_takes_pygame_surfaces(tmp_path):
    """A pygame surface is read as (H, W, 3) pixels, and ``end_recording``
    adds 10 frames of the final surface."""
    import pygame
    from PIL import Image

    from gobblet_rl_torch.render.gif import GIFRecorder

    surf = pygame.Surface((48, 32))
    surf.fill((200, 10, 30))
    rec = GIFRecorder(out_file=str(tmp_path / "s.gif"))
    rec.capture_frame(surf)
    assert rec.frames[0].shape == (32, 48, 3)
    assert tuple(rec.frames[0][5, 7]) == (200, 10, 30)
    rec.end_recording(surf)
    assert rec.frame_num == 11
    img = Image.open(tmp_path / "s.gif")
    assert img.size == (48, 32)


def test_session_stats_dict_shape():
    """``collect_result`` returns the reference collector's dict."""
    from gobblet_rl_torch import gobblet_v1
    from gobblet_rl_torch.interactive.session import GameSession

    session = GameSession(gobblet_v1.env(render_mode=None))
    result = session.collect_result(np.array(18))
    assert set(result) == {"n/ep", "n/st", "rews", "lens", "idxs", "rew", "len", "rew_std",
                           "len_std"}
    assert result["n/ep"] == 0 and result["n/st"] == 1
    assert result["rews"].dtype == np.float64 and len(result["rews"]) == 0


def test_throughput_meter():
    from gobblet_rl_torch.utils import profiling

    t = profiling.Throughput()
    x = torch.ones(1024).sum()
    assert t.rate(1000, x) > 0
    assert t.rate(10, {"a": [x, (x,)], "b": None}) > 0
    t.reset()
    assert t.rate(1) > 0


def test_trace_writes_a_chrome_trace_naming_the_annotation(tmp_path):
    from gobblet_rl_torch.utils import profiling

    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("host_search_move"):
            torch.ones(64, 64).matmul(torch.ones(64, 64))
    files = list(tmp_path.glob("trace-*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "host_search_move" for e in events)
    assert any(e.key == "host_search_move" for e in prof.key_averages())
    with profiling.trace(str(tmp_path)):
        pass
    assert len(list(tmp_path.glob("trace-*.json"))) == 2


def test_helpers():
    from gobblet_rl_torch.utils.helpers import find_file_in_subdir, get_project_root

    root = get_project_root()
    assert (root / "gobblet_rl_torch" / "__init__.py").exists()
    assert (root / "csrc" / "gobblet.cpp").exists()
    found = find_file_in_subdir(root / "gobblet_rl_torch", "helpers.py")
    assert found is not None and found.endswith(os.path.join("utils", "helpers.py"))
    assert find_file_in_subdir(root / "gobblet_rl_torch", "*.py", regex_match=r".*/zoo/") \
        .endswith("zoo/flax_msgpack.py")
    assert find_file_in_subdir(root / "gobblet_rl_torch", "no_such_file.txt") is None
