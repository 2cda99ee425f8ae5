"""The torch port's tournament and command lines: match accounting, the
metrics logger, a tiny DQN CLI training run whose ``--full-resume-dir``
relaunch continues the schedule, a tiny AlphaZero CLI run with its
evaluation, and a tiny PPO CLI league run relaunched from its
``--checkpoint-dir``."""

import json

import pytest
import torch

from gobblet_rl_torch.eval import tournament
from gobblet_rl_torch.examples import example_alphazero, example_dqn, example_ppo
from gobblet_rl_torch.train import checkpoint as ckpt
from gobblet_rl_torch.train.logging import make_logger

CPU = torch.device("cpu")


def test_match_accounting():
    m = tournament.play_match(tournament.random_policy(), tournament.random_policy(),
                              num_games=128, seed=0, device=CPU)
    assert m["games"] == 128
    assert m["wins"] + m["losses"] + m["undecided"] == 128
    assert m["undecided"] <= 10  # random games essentially always finish
    again = tournament.play_match(tournament.random_policy(), tournament.random_policy(),
                                  num_games=128, seed=0, device=CPU)
    assert again == m


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes on a few cores, where torch's thread pools would oversubscribe
    them and small ops slow down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_greedy_beats_random_in_a_match():
    m = tournament.play_match(tournament.greedy_policy(1), tournament.random_policy(),
                              num_games=64, seed=1, swap_colors=False, device=CPU)
    assert m["win_rate"] > 0.8, m


def test_metrics_logger(tmp_path):
    logger = make_logger(str(tmp_path / "log"), {"seed": 1})
    logger.log({"loss": 0.5, "win_rate": 0.9, "grad_steps": 10})
    logger.close()
    lines = (tmp_path / "log" / "history.jsonl").read_text().strip().split("\n")
    assert json.loads(lines[0])["loss"] == 0.5


def cli_args(tmp_path, *extra):
    return example_dqn.get_parser().parse_args([
        "--device", "cpu", "--logdir", str(tmp_path / "log"), "--opponent", "random",
        "--both-seats", "--training-num", "32", "--buffer-size", "1024",
        "--step-per-epoch", "2", "--step-per-collect", "4", "--batch-size", "64",
        "--hidden-sizes", "32", "32", "--full-resume-dir", str(tmp_path / "resume"), *extra])


def test_cli_trains_and_resumes(tmp_path):
    ts, history = example_dqn.main(cli_args(tmp_path, "--epoch", "1"))
    assert [h["epoch"] for h in history] == [0]
    logdir = tmp_path / "log" / "gobblet_rl_torch" / "dqn"
    records = [json.loads(x) for x in (logdir / "history.jsonl").read_text().splitlines()]
    assert len(records) == 1 and records[0]["grad_steps"] == ts.grad_steps == 4
    assert ckpt.latest_step(str(logdir / "ckpt")) == 4
    assert ckpt.latest_step(str(tmp_path / "resume")) == 0

    ts2, history2 = example_dqn.main(cli_args(tmp_path, "--epoch", "2"))
    assert [h["epoch"] for h in history2] == [1]
    assert ts2.grad_steps == 2 * ts.grad_steps
    assert len((logdir / "history.jsonl").read_text().splitlines()) == 2
    ts3, history3 = example_dqn.main(cli_args(tmp_path, "--epoch", "2"))
    assert history3 == [] and ts3.grad_steps == ts2.grad_steps


def test_cli_config_and_host_modes(monkeypatch):
    """The config from the flags; ``--watch`` and ``--cpu-players 1`` go to
    the host surface's watch and play modes (tests/test_torch_host_*.py run
    them), not to training."""
    args = example_dqn.get_parser().parse_args(
        ["--step-per-collect", "8", "--update-per-step", "0.25", "--agent-id", "1"])
    config = example_dqn.make_config(args)
    assert args.device == "cuda"
    assert config.update_per_collect == 2 and config.learner_player == 0
    assert config.segment_len == 8 and config.opponent == "random"
    calls = []
    monkeypatch.setattr(example_dqn, "watch", lambda a: calls.append(("watch", a)))
    monkeypatch.setattr(example_dqn, "play", lambda a: calls.append(("play", a)))
    monkeypatch.setattr(example_dqn, "train_agent", lambda a: calls.append(("train", a)))
    for flag, mode in ((["--watch"], "watch"), (["--cpu-players", "1"], "play"), ([], "train")):
        parsed = example_dqn.get_parser().parse_args(flag)
        example_dqn.main(parsed)
        assert calls[-1] == (mode, parsed)
    assert len(calls) == 3


def az_args(tmp_path, *extra):
    return example_alphazero.get_parser().parse_args([
        "--device", "cpu", "--logdir", str(tmp_path / "log"), "--num-envs", "8",
        "--num-sims", "6", "--segment-len", "8", "--model", "mlp", "--eval-sims", "4", *extra])


@pytest.mark.parametrize("search", ["gumbel", "puct"])
def test_alphazero_cli_trains_and_evaluates(tmp_path, capsys, search):
    st, history = example_alphazero.main(az_args(
        tmp_path, "--search", search, "--iterations", "2", "--eval-games", "8",
        "--full-resume-dir", str(tmp_path / "resume")))
    assert [h["iteration"] for h in history] == [0, 1]
    out = capsys.readouterr().out
    for name in ("random", "greedy-1", "greedy-2"):
        assert f"alphazero vs {name}: " in out and "'games': 8" in out
    logdir = tmp_path / "log" / "gobblet_rl_torch" / "alphazero"
    assert len((logdir / "history.jsonl").read_text().splitlines()) == 2
    _, again = example_alphazero.main(az_args(
        tmp_path, "--search", search, "--iterations", "2", "--eval-games", "0",
        "--full-resume-dir", str(tmp_path / "resume")))
    assert again == [] and "resumed at end" in capsys.readouterr().out


@pytest.mark.parametrize("flags,item", [(["--watch"], "A.17"),
                                        (["--eval-alphabeta-depth", "2"], "A.14")])
def test_alphazero_cli_unported_modes_raise(flags, item, tmp_path, capsys, monkeypatch):
    """The modes that once waited: ``--watch``, which waited for the host
    surface (A.17), now renders one game instead of training
    (tests/test_torch_host_watch.py plays it); ``--eval-alphabeta-depth``,
    which waited for the native alpha-beta (A.14), evaluates against it."""
    args = example_alphazero.get_parser().parse_args(flags)
    assert args.device == "cuda" and args.search == "puct"
    if item == "A.17":
        calls = []
        monkeypatch.setattr(example_alphazero, "watch", lambda a: calls.append(a))
        assert example_alphazero.main(args) is None and calls == [args]
        return
    example_alphazero.main(az_args(tmp_path, *flags, "--search", "gumbel", "--iterations", "1",
                                   "--eval-games", "4"))
    out = capsys.readouterr().out
    assert "alphazero vs alphabeta-2: " in out and "'games': 4" in out


def ppo_args(tmp_path, *extra):
    return example_ppo.get_parser().parse_args([
        "--device", "cpu", "--logdir", str(tmp_path / "log"), "--num-envs", "16",
        "--segment-len", "4", "--shared-policy", "--learner-player", "both",
        "--opponent", "mixed", "--mixed-weights", "0.4", "0.3", "0.3",
        "--defense-bc-weight", "1.0", "--defense-bank-games", "4", "--defense-bank-sides", "both",
        "--checkpoint-dir", str(tmp_path / "ckpt"), *extra])


def test_ppo_cli_trains_and_resumes(tmp_path, capsys):
    """The league with the defense term for 2 iterations, relaunched for a
    third: exactly one more iteration runs, and a finished run trains
    nothing."""
    from gobblet_rl_torch.native import engine

    try:
        st, history = example_ppo.main(ppo_args(tmp_path, "--iterations", "2"))
        assert [h["iteration"] for h in history] == [0, 1]
        logdir = tmp_path / "log" / "gobblet_rl_torch" / "ppo"
        assert len((logdir / "history.jsonl").read_text().splitlines()) == 2
        assert ckpt.latest_step(str(tmp_path / "ckpt")) == 1
        _, again = example_ppo.main(ppo_args(tmp_path, "--iterations", "3"))
        assert [h["iteration"] for h in again] == [2]
        assert len((logdir / "history.jsonl").read_text().splitlines()) == 3
        _, done = example_ppo.main(ppo_args(tmp_path, "--iterations", "3"))
        assert done == [] and "resumed at end" in capsys.readouterr().out
    finally:
        engine.solve_tt_clear()
    args = example_ppo.get_parser().parse_args(["--resume"])
    assert args.device == "cuda" and example_ppo.make_config(args).defense_bank_depth == 16
    with pytest.raises(SystemExit, match="--checkpoint-dir"):
        example_ppo.main(args)
