"""The torch port's watch modes and host search agent against the JAX
package's, on the CPU.

Twins of ``tests/test_examples.py``'s ``example_dqn`` and
``example_alphazero`` watches (text render, ``--device cpu``), plus
transcripts equal to JAX's byte for byte where the seed fixes the game: the
watches run exact float32 nets (weights multiples of 2^-6,
``tests/torch_parity.py``) on both sides, and the zoo's ``dqn_greedy``,
whose bf16 Q-values pick the same moves in both frameworks in this game.
The opponents (random, host greedy, alpha-beta) draw as JAX's.
"""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.torch_parity import exact_nets, exact_qnets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "SDL_VIDEODRIVER": "dummy", "SDL_AUDIODRIVER": "dummy",
       "PYTHONPATH": REPO, "PYGAME_HIDE_SUPPORT_PROMPT": "1"}


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


def run_module(args, timeout=240):
    return subprocess.run([sys.executable, "-m", *args], cwd=REPO, env=ENV, timeout=timeout,
                          capture_output=True, text=True)


@pytest.mark.parametrize("opponent", ["random", "greedy"])
def test_example_dqn_watch_equals_jax_exact_net(opponent, monkeypatch):
    """The watch of a plain-headed float32 Q-net, exact in both frameworks
    (JAX's ``make_net`` patched to build it, its params passed in)."""
    from gobblet_rl_torch.examples import example_dqn as t
    from gobblet_rl_tpu.examples import example_dqn as j
    from gobblet_rl_tpu.train import dqn as jdqn

    jnet, params, tnet = exact_qnets(seed=4)
    monkeypatch.setattr(jdqn, "make_net", lambda config: jnet)
    argv = ["--watch", "--render_mode", "text", "--opponent", opponent, "--seed", "4"]
    out = transcript(t.watch, t.get_parser().parse_args(argv + ["--device", "cpu"]), net=tnet)
    assert "Final rewards" in out
    assert out == transcript(j.watch, j.get_parser().parse_args(argv), params=params)


def test_example_dqn_watch_zoo_equals_jax():
    from gobblet_rl_torch.examples import example_dqn as t
    from gobblet_rl_tpu.examples import example_dqn as j

    argv = ["--watch", "--render_mode", "text", "--opponent", "random", "--seed", "4",
            "--zoo", "dqn_greedy"]
    out = transcript(t.main, t.get_parser().parse_args(argv + ["--device", "cpu"]))
    assert out.count("TURN") >= 5 and "Final rewards" in out
    assert out == transcript(j.main, j.get_parser().parse_args(argv))


@pytest.mark.parametrize("opponent", ["random", "greedy", "alphabeta"])
def test_example_alphazero_watch_equals_jax_exact_net(opponent):
    """The PUCT agent (12 simulations) of an exact float32 MLP against each
    opponent: JAX's transcript byte for byte."""
    from gobblet_rl_torch.examples import example_alphazero as t
    from gobblet_rl_tpu.examples import example_alphazero as j

    jnet, params, tnet = exact_nets(seed=3)
    argv = ["--watch", "--render_mode", "text", "--opponent", opponent, "--eval-sims", "12",
            "--seed", "6"]
    out = transcript(t.watch, t.get_parser().parse_args(argv + ["--device", "cpu"]), net=tnet)
    assert "Final rewards" in out
    assert out == transcript(j.watch, j.get_parser().parse_args(argv), net=jnet, params=params)


def test_example_dqn_watch_text_cli():
    """Twin of the JAX CLI test: a fresh net, through ``python -m``."""
    r = run_module(["gobblet_rl_torch.examples.example_dqn", "--watch", "--render_mode", "text",
                    "--opponent", "random", "--seed", "4", "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "Final rewards" in r.stdout


def test_example_alphazero_watch_text_cli():
    r = run_module(["gobblet_rl_torch.examples.example_alphazero", "--watch", "--render_mode",
                    "text", "--opponent", "random", "--eval-sims", "12", "--model", "mlp",
                    "--seed", "6", "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "Final rewards" in r.stdout


def test_search_agent_policy_plays_legal_moves():
    """``SearchAgentPolicy`` on the zoo's conv net at 8 simulations gives a
    legal move from both seats; ``device=None`` means the card."""
    from gobblet_rl_torch import zoo
    from gobblet_rl_torch.core import observe, rules_np
    from gobblet_rl_torch.examples.example_alphazero import SearchAgentPolicy

    net, _, _ = zoo.load("alphazero_gumbel32", device="cpu")
    agent = SearchAgentPolicy(net, num_sims=8, seed=0, device="cpu")
    board, player = rules_np.empty_board(), 0
    for _ in range(6):
        obs, mask = observe.observe_np(board, player, player)
        a = agent.compute_action(obs, mask)
        assert mask[a] == 1
        board, player = rules_np.apply_action(board, player, a), 1 - player
        if rules_np.line_winner(board):
            break
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            SearchAgentPolicy(net, num_sims=8)
