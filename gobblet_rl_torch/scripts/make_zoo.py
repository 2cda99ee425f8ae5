"""Train the flagship agents and write a model zoo the JAX package can read.

Port of ``scripts/make_zoo.py``: the same recipes, full and ``--quick``,
trained on ``--device`` (default: the card), measured against random and
the greedy baselines (``--eval-games`` color-swapped games each) and saved
as flax msgpack blobs plus manifest rows into ``--zoo-dir`` (default
``zoo_torch/`` at the repository's root; never the committed zoo):

    python -m gobblet_rl_torch.scripts.make_zoo                 # full recipes
    python -m gobblet_rl_torch.scripts.make_zoo --quick --device cpu

``ppo_league``'s search leg plays the ``alphazero_gumbel32`` entry of the
zoo being written, so it is trained only when that entry is there (run
the entries in their default order).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
RECIPE = "gobblet_rl_torch/scripts/make_zoo.py"


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--quick", action="store_true",
                   help="tiny recipes for smoke-testing the pipeline")
    p.add_argument("--entries", nargs="*",
                   default=["alphazero_gumbel32", "dqn_greedy", "ppo_league"])
    p.add_argument("--eval-games", type=int, default=256)
    p.add_argument("--seed", type=int, default=1626)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--zoo-dir", type=str, default=str(REPO / "zoo_torch"),
                   help="where the blobs and manifest.json go ($GOBBLET_ZOO_DIR)")
    return p


def measure(policy, eval_games: int, seed: int, device,
            opponents=("random", "greedy-1", "greedy-2")) -> dict:
    """``vs_<opponent>`` win rates, rounded to 3 places."""
    from gobblet_rl_torch.eval import tournament

    build = {
        "random": tournament.random_policy,
        "greedy-1": lambda: tournament.greedy_policy(1),
        "greedy-2": lambda: tournament.greedy_policy(2),
    }
    out = {}
    for name in opponents:
        res = tournament.play_match(policy, build[name](), num_games=eval_games, seed=seed,
                                    device=device)
        out[f"vs_{name}"] = round(res["win_rate"], 3)
        print(f"  vs {name}: {res}", flush=True)
    return out


def alphazero_config(args):
    from gobblet_rl_torch.train import alphazero

    return alphazero.AZConfig(
        search="gumbel_lm", num_sims=32, iterations=8 if args.quick else 100,
        num_envs=64 if args.quick else 512, segment_len=48, temp_moves=8,
        model="conv", seed=args.seed,
    )


def make_alphazero(args, device) -> None:
    from gobblet_rl_torch import zoo
    from gobblet_rl_torch.train import alphazero

    config = alphazero_config(args)
    t0 = time.time()
    st, history = alphazero.train(config, device=device)
    mins = (time.time() - t0) / 60
    print(f"alphazero trained in {mins:.1f} min; "
          f"final value loss {history[-1]['value_loss']:.4f}", flush=True)
    eval_kw = {"num_sims": 32 if args.quick else 128}
    metrics = measure(alphazero.az_policy(st.net, **eval_kw), args.eval_games, args.seed, device)
    metrics["final_value_loss"] = round(history[-1]["value_loss"], 4)
    metrics["train_minutes"] = round(mins, 1)
    zoo.save("alphazero_gumbel32", st.net, {
        "family": "alphazero",
        "net": {"model": "conv", "channels": config.channels, "blocks": config.blocks},
        "eval": {"num_sims": 128},
        "recipe": (f"{RECIPE}: AZConfig(search='{config.search}', "
                   f"num_sims=32, iterations={config.iterations}, "
                   f"num_envs={config.num_envs}, segment_len=48, "
                   f"model='conv', seed={args.seed})"),
        "metrics": metrics,
    })


def dqn_config(args):
    from gobblet_rl_torch.train import dqn

    return dqn.DQNConfig(
        opponent="greedy", epoch=4 if args.quick else 120,
        step_per_epoch=4 if args.quick else 24,
        num_envs=64 if args.quick else 1024, seed=args.seed,
        learner_player="both",   # seat-agnostic: honest color-swapped play
    )


def make_dqn(args, device) -> None:
    from gobblet_rl_torch import zoo
    from gobblet_rl_torch.eval import tournament
    from gobblet_rl_torch.train import dqn

    config = dqn_config(args)
    t0 = time.time()
    ts, history = dqn.train(config, device=device)
    mins = (time.time() - t0) / 60
    print(f"dqn trained in {mins:.1f} min; "
          f"final eval win-rate {history[-1]['win_rate']:.3f}", flush=True)
    metrics = measure(tournament.dqn_policy(ts.net), args.eval_games, args.seed, device)
    metrics["final_greedy_eval_win_rate"] = round(history[-1]["win_rate"], 3)
    metrics["train_minutes"] = round(mins, 1)
    zoo.save("dqn_greedy", ts.net, {
        "family": "dqn",
        "net": {"hidden_sizes": list(config.hidden_sizes), "dueling": config.dueling},
        "recipe": (f"{RECIPE}: DQNConfig(opponent='greedy', "
                   f"epoch={config.epoch}, step_per_epoch={config.step_per_epoch}, "
                   f"num_envs={config.num_envs}, double/dueling on, "
                   f"learner_player='both', seed={args.seed})"),
        "metrics": metrics,
    })


def ppo_config(args):
    """The league of the JAX recipe (greedy-heavy snapshot league, the
    zoo's AlphaZero net as a search attacker at 4 simulations, and the
    solver-supervised defense term over a bank of both sides); without an
    ``alphazero_gumbel32`` entry in the zoo being written, the search leg
    is dropped."""
    from gobblet_rl_torch import zoo
    from gobblet_rl_torch.train import ppo

    have_az = "alphazero_gumbel32" in zoo.names()
    return ppo.PPOConfig(
        shared_policy=True, learner_player="both", opponent="mixed",
        mixed_weights=((0.1, 0.6, 0.2, 0.1) if have_az else (0.1, 0.7, 0.2)),
        search_sims=4,
        defense_bc_weight=1.0,
        defense_bank_games=16 if args.quick else 384,
        defense_bank_depth=12 if args.quick else 16,
        defense_bank_sides="both",
        iterations=8 if args.quick else 1000,
        num_envs=64 if args.quick else 512, seed=args.seed,
    )


def make_ppo(args, device) -> None:
    from gobblet_rl_torch import zoo
    from gobblet_rl_torch.eval import tournament
    from gobblet_rl_torch.train import ppo

    config = ppo_config(args)
    t0 = time.time()
    st, history = ppo.train(config, device=device)
    mins = (time.time() - t0) / 60
    print(f"ppo trained in {mins:.1f} min", flush=True)
    pol = tournament.ppo_policy(st.nets[0])
    metrics = measure(pol, args.eval_games, args.seed, device)
    if not args.quick:
        d = tournament.defense_audit(pol, num_games=32, seed=args.seed, depth=16, device=device)
        metrics["defense_plies_survived"] = round(d["mean_plies_survived"], 1)
        metrics["defense_mistakes_per_game"] = round(d["mistakes_per_game"], 2)
        print(f"  defense audit: {d}", flush=True)
    metrics["train_minutes"] = round(mins, 1)
    zoo.save("ppo_league", st.nets[0], {
        "family": "ppo",
        "net": {"hidden_sizes": list(config.hidden_sizes)},
        "recipe": (f"{RECIPE}: PPOConfig(shared_policy=True, "
                   f"learner_player='both', opponent='mixed', "
                   f"mixed_weights={config.mixed_weights}, "
                   f"search_sims={config.search_sims}, "
                   f"defense_bc_weight={config.defense_bc_weight}, "
                   f"defense_bank_games={config.defense_bank_games}, "
                   f"defense_bank_sides='{config.defense_bank_sides}', "
                   f"iterations={config.iterations}, num_envs={config.num_envs}, "
                   f"seed={args.seed})"),
        "metrics": metrics,
    })


MAKERS = {"alphazero_gumbel32": make_alphazero, "dqn_greedy": make_dqn,
          "ppo_league": make_ppo}


def main(argv=None) -> None:
    args = get_parser().parse_known_args(argv)[0]
    import torch

    from gobblet_rl_torch.device import resolve_device

    device = resolve_device(args.device)
    os.environ["GOBBLET_ZOO_DIR"] = os.path.abspath(args.zoo_dir)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {device} ({name}); zoo: {os.environ['GOBBLET_ZOO_DIR']}", flush=True)
    for entry in args.entries:
        print(f"=== {entry} ===", flush=True)
        MAKERS[entry](args, device)

    from gobblet_rl_torch import zoo

    print(json.dumps({n: zoo.meta(n)["metrics"] for n in zoo.names()}, indent=2))


if __name__ == "__main__":
    main()
