"""The torch port's round robin, ``play_match`` and tournament command line
against the JAX package's, on the CPU.

``round_robin`` with ``play_match`` patched in both packages to return the
same pair results gives the same standings and Elo (the fit is float
arithmetic in pair order, so equal means equal).  ``play_match`` between
two deterministic policies, the argmax ``dqn_policy`` of an exact float32
``QNet`` and the argmax ``ppo_policy`` of an exact ``MLPActorCritic``, gives
JAX's result dict, colours swapped and not, for three pairs of nets (with
deterministic policies every game of a half is the same game, so the pairs
of nets are what varies the games).  The command line ranks its entrants,
reads the port's checkpoints, and parses ``--max-plies`` without passing
it on, as JAX's does.
"""

import json

import numpy as np
import pytest
import torch

from gobblet_rl_torch.eval import tournament as ttour
from gobblet_rl_torch.examples import example_tournament
from gobblet_rl_torch.native import engine
from gobblet_rl_tpu.eval import tournament as jtour
from tests.torch_parity import CPU, exact_nets, exact_qnets


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes on a few cores, where torch's thread pools would oversubscribe
    them and small ops slow down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_round_robin_equals_jax_with_patched_play_match(monkeypatch):
    """Four entrants, six pairs played in ``names`` order, one with no
    decided game (skipped by the fit); each package's ``play_match`` is
    replaced by the same sequence of results."""
    rng = np.random.default_rng(0)
    results = []
    for i in range(6):
        games = 64
        wins = 0 if i == 4 else int(rng.integers(0, 40))
        losses = 0 if i == 4 else int(rng.integers(0, games - wins))
        results.append({"games": games, "wins": wins, "losses": losses,
                        "undecided": games - wins - losses,
                        "win_rate": wins / max(wins + losses, 1)})

    def fake(calls):
        def play_match(policy_a, policy_b, num_games, seed=0, **kwargs):
            calls.append((policy_a, policy_b, num_games, seed))
            return dict(results[len(calls) - 1])
        return play_match

    jcalls, tcalls = [], []
    monkeypatch.setattr(jtour, "play_match", fake(jcalls))
    monkeypatch.setattr(ttour, "play_match", fake(tcalls))
    names = ["d", "a", "c", "b"]
    want = jtour.round_robin({n: n for n in names}, num_games=64, seed=3)
    got = ttour.round_robin({n: n for n in names}, num_games=64, seed=3, device=CPU)
    assert tcalls == jcalls and [c[:2] for c in tcalls] == [
        ("d", "a"), ("d", "c"), ("d", "b"), ("a", "c"), ("a", "b"), ("c", "b")]
    assert list(got["pairs"]) == list(want["pairs"])
    assert got == want
    assert len({row["elo"] for row in got["standings"].values()}) == 4


def test_greedy_orders_by_depth():
    res = ttour.round_robin({"random": ttour.random_policy(), "greedy1": ttour.greedy_policy(1),
                             "greedy2": ttour.greedy_policy(2)}, num_games=96, seed=1,
                            device=CPU)
    elo = {k: v["elo"] for k, v in res["standings"].items()}
    assert elo["greedy2"] > elo["greedy1"] > elo["random"], elo


@pytest.mark.parametrize("swap", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_play_match_equals_jax(seed, swap):
    jq, qparams, tq = exact_qnets(seed=seed)
    jac, acparams, tac = exact_nets(seed=seed + 10)
    want = jtour.play_match(jtour.dqn_policy(jq, qparams), jtour.ppo_policy(jac, acparams),
                            num_games=64, seed=seed, swap_colors=swap)
    got = ttour.play_match(ttour.dqn_policy(tq), ttour.ppo_policy(tac), num_games=64,
                           seed=seed, swap_colors=swap, device=CPU)
    assert got == want
    assert got["wins"] + got["losses"] + got["undecided"] == 64


def test_tournament_cli_ranks_the_search_entrant(capsys):
    args = example_tournament.get_parser().parse_args(
        ["--device", "cpu", "--agents", "random", "alphabeta-2", "--zoo-search", "dqn_greedy",
         "--games", "8", "--json"])
    res = example_tournament.main(args)
    engine.solve_tt_clear()
    assert json.loads(capsys.readouterr().out) == res
    assert list(res["standings"]) == ["random", "alphabeta-2", "dqn_greedy+search2"]
    elo = {k: v["elo"] for k, v in res["standings"].items()}
    assert elo["alphabeta-2"] > elo["random"] and elo["dqn_greedy+search2"] > elo["random"], elo
    for pair in res["pairs"].values():
        assert pair["wins"] + pair["losses"] + pair["undecided"] == pair["games"] == 8


def test_tournament_cli_checkpoints(tmp_path, monkeypatch):
    """``--dqn-checkpoint`` and ``--az-checkpoint`` enter the port's saved
    nets as 'dqn' and 'alphazero'; ``--max-plies`` is parsed and not passed
    on to ``round_robin``."""
    from gobblet_rl_torch.train import alphazero
    from gobblet_rl_torch.train import checkpoint as ckpt
    from gobblet_rl_torch.train import dqn

    gen = torch.Generator().manual_seed(1)
    config = dqn.DQNConfig(hidden_sizes=(32, 32), dueling=True)
    ts = dqn.init_train_state(config, dqn.make_net(config, CPU), gen)
    ckpt.save(str(tmp_path / "dqn"), ts, step=0)
    az = alphazero.init_alphazero(alphazero.AZConfig(model="mlp", num_envs=8), gen)
    ckpt.save_az(str(tmp_path / "az"), az, step=0)

    seen = {}

    def recording(policies, **kwargs):
        seen.update(kwargs, names=list(policies))
        board = torch.zeros((3, 9, 2), dtype=torch.int8)
        current = torch.zeros(2, dtype=torch.int32)
        for name in ("dqn", "alphazero"):
            actions = policies[name](torch.Generator().manual_seed(0), board, current)
            assert actions.dtype == torch.int32 and actions.shape == (2,)
        return {"standings": {}, "pairs": {}}

    monkeypatch.setattr(ttour, "round_robin", recording)
    args = example_tournament.get_parser().parse_args(
        ["--device", "cpu", "--agents", "random", "--dqn-checkpoint", str(tmp_path / "dqn"),
         "--dqn-hidden-sizes", "32", "32", "--az-checkpoint", str(tmp_path / "az"),
         "--az-model", "mlp", "--az-num-envs", "8", "--az-sims", "4", "--games", "8",
         "--max-plies", "7", "--json"])
    assert args.max_plies == 7
    example_tournament.main(args)
    assert seen == {"names": ["random", "alphazero", "dqn"], "num_games": 8, "seed": 0,
                    "device": CPU}
    with pytest.raises(SystemExit):
        example_tournament.main(example_tournament.get_parser().parse_args(
            ["--device", "cpu", "--agents", "random", "--dqn-checkpoint",
             str(tmp_path / "none")]))
