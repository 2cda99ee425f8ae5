"""The port's desktop demos and tutorials against the JAX package's: the
same transcripts under the seeds of tests/test_examples.py (``main`` and
``main_random``) and of the greedy tutorial; the AlphaZero tutorial trains
on the CPU and plays one legal game; the package versions agree."""

import asyncio
import importlib
import importlib.util
import runpy
import sys
from pathlib import Path

import pytest
import torch

import gobblet_rl_torch
import gobblet_rl_tpu
from gobblet_rl_torch import gobblet_v1
from gobblet_rl_torch.examples import main as tmain
from gobblet_rl_torch.examples import main_random as tmain_random
from gobblet_rl_torch.tutorials import tutorial_alphazero, tutorial_greedy

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes on a few cores, where torch's thread pools would oversubscribe
    them and small ops slow down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def load_script(path: Path):
    spec = importlib.util.spec_from_file_location(f"jax_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def transcript(capsys, fn) -> str:
    capsys.readouterr()
    fn()
    return capsys.readouterr().out


@pytest.mark.parametrize("argv", [["--render_mode", "text", "--seed", "9", "--games", "1",
                                   "--depth", "1"],
                                  ["--render_mode", "text", "--seed", "4", "--games", "2"]])
def test_main_prints_what_jax_prints(argv, capsys, monkeypatch):
    script = load_script(REPO / "main.py")
    monkeypatch.setattr(sys, "argv", ["main.py", *argv])
    want = transcript(capsys, lambda: asyncio.run(script.main()))
    got = transcript(capsys, lambda: asyncio.run(tmain.main(argv)))
    assert "TURN" in got and got == want


@pytest.mark.parametrize("seed", ["3", "11"])
def test_main_random_prints_what_jax_prints(seed, capsys, monkeypatch):
    argv = ["--render_mode", "text", "--seed", seed]
    script = load_script(REPO / "main_random.py")
    monkeypatch.setattr(sys, "argv", ["main_random.py", *argv])
    want = transcript(capsys, script.main)
    got = transcript(capsys, lambda: tmain_random.main(argv))
    assert "TURN" in got and got == want


def test_main_pumps_once_a_ply(monkeypatch):
    """One cooperative yield per ply, as the browser loop needs."""
    yields = []
    real_sleep = asyncio.sleep

    async def counting_sleep(delay):
        yields.append(delay)
        await real_sleep(delay)

    monkeypatch.setattr(tmain.asyncio, "sleep", counting_sleep)
    env = gobblet_v1.env(render_mode=None)
    plies = []
    real_step = env.step

    def step(action):
        if action is not None:
            plies.append(action)
        real_step(action)

    env.step = step
    from gobblet_rl_torch.policies.greedy import GreedyGobbletPolicy

    policies = {a: GreedyGobbletPolicy(depth=1) for a in ["player_1", "player_2"]}
    asyncio.run(tmain.play_games(env, policies, games=2, move_delay=0.0))
    assert len(yields) == len(plies) > 0 and set(yields) == {0}


def test_tutorial_greedy_prints_what_jax_prints(capsys):
    want = transcript(capsys, lambda: runpy.run_path(
        str(REPO / "tutorials" / "GreedyAgent" / "tutorial_greedy.py"), run_name="__main__"))
    got = transcript(capsys, tutorial_greedy.main)
    assert got.count("Game ") == 6 and got == want


class CheckedEnv:
    """The AEC env with every action checked against its mask."""

    def __init__(self, env):
        self._env = env
        self.actions = []

    def __getattr__(self, name):
        return getattr(self._env, name)

    def step(self, action):
        if action is not None:
            obs = self._env.last()[0]
            assert obs["action_mask"][action] == 1, action
            self.actions.append((self._env.agent_selection, action))
        self._env.step(action)


def test_tutorial_alphazero_trains_and_plays(capsys, monkeypatch):
    config, st = tutorial_alphazero.train_tiny(device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in lines] == ["iteration 0", "iteration 1",
                                                      "iteration 2"]
    assert config.iterations == 3 and config.model == "mlp" and config.hidden_sizes == (64, 64)
    assert config.search == "gumbel"
    envs, real_env = [], gobblet_v1.env

    def make_env(**kw):
        envs.append(CheckedEnv(real_env(**kw)))
        return envs[-1]

    monkeypatch.setattr(tutorial_alphazero.gobblet_v1, "env", make_env)
    tutorial_alphazero.watch(config, st)
    out = capsys.readouterr().out
    assert "reward" in out and len(envs) == 1
    movers = {agent for agent, _ in envs[0].actions}
    assert movers == {"player_1", "player_2"}
    rewards = sorted(int(line.rsplit(" ", 1)[1]) for line in out.splitlines()
                     if line.startswith("agent "))
    assert rewards in ([-1, 1], [0, 0])


def test_tutorial_alphazero_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tutorial_alphazero.train_tiny()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tutorial_alphazero.main([])


def test_version_equals_jax():
    module = importlib.import_module("gobblet_rl_torch.__version__")
    want = importlib.import_module("gobblet_rl_tpu.__version__").__version__
    assert module.__version__ == gobblet_rl_torch.__version__ == want == gobblet_rl_tpu.__version__
    assert want == "0.2.0"
