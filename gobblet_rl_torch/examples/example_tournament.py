"""Round-robin Elo tournament over the framework's agents, in the torch port.

    python -m gobblet_rl_torch.examples.example_tournament \
        --agents random greedy-1 greedy-2 alphabeta-4 --zoo-search dqn_greedy --games 128

Port of ``gobblet_rl_tpu/examples/example_tournament.py``, with the same
flags plus ``--device`` (default ``cuda``).  Every pairing is a
colour-swapped batched match (``eval/tournament.py``) and the standings
come with an Elo fit.  ``--az-checkpoint`` reads a ``save_az`` checkpoint
and ``--dqn-checkpoint`` a ``save`` checkpoint of
``gobblet_rl_torch/train/checkpoint.py``.  ``--max-plies`` is parsed and,
as in the JAX command line, not passed on: ``round_robin`` plays
``play_match``'s 100 plies.
"""

from __future__ import annotations

import argparse
import json


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--agents", type=str, nargs="*",
        default=["random", "greedy-1", "greedy-2", "alphabeta-4"],
        help="any of: random, greedy-D (batched greedy at depth D), alphabeta-D (native "
        "expert at depth D), solver-D (exact oracle at solve depth D; D >= 13 is perfect "
        "play)")
    parser.add_argument("--az-checkpoint", type=str, default=None,
                        help="add an 'alphazero' entry from a save_az checkpoint dir "
                        "(train/checkpoint.py)")
    parser.add_argument("--az-sims", type=int, default=128)
    parser.add_argument("--az-model", type=str, default="conv", choices=["conv", "mlp"])
    parser.add_argument("--az-num-envs", type=int, default=256,
                        help="num_envs the checkpoint was trained with (its env batch is "
                        "restored with the net)")
    parser.add_argument("--dqn-checkpoint", type=str, default=None,
                        help="add a 'dqn' entry from a checkpoint dir (train/checkpoint.py "
                        "save of a dqn.TrainState)")
    parser.add_argument("--dqn-hidden-sizes", type=int, nargs="*",
                        default=[128, 128, 128, 128])
    parser.add_argument("--dqn-dueling", action=argparse.BooleanOptionalAction, default=True)
    parser.add_argument("--zoo", type=str, nargs="*", default=[],
                        help="add entries from the committed model zoo (e.g. "
                        "alphazero_gumbel32 dqn_greedy ppo_league)")
    parser.add_argument("--zoo-search", type=str, nargs="*", default=[],
                        help="add depth-2 learned-eval search entrants over zoo value heads "
                        "(policies/value_search.py); each NAME appears as 'NAME+search2'")
    parser.add_argument("--games", type=int, default=128,
                        help="games per pairing (colour-swapped)")
    parser.add_argument("--max-plies", type=int, default=100)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--json", action="store_true",
                        help="print machine-readable results only")
    parser.add_argument("--device", type=str, default="cuda")
    return parser


def build_policy(name: str):
    from gobblet_rl_torch.eval import tournament

    if name == "random":
        return tournament.random_policy()
    if name.startswith("greedy-"):
        return tournament.greedy_policy(int(name.split("-")[1]))
    if name.startswith("alphabeta-"):
        return tournament.alphabeta_policy(int(name.split("-")[1]))
    if name.startswith("solver-"):
        return tournament.solver_policy(int(name.split("-")[1]))
    raise SystemExit(f"unknown agent {name!r}")


def main(args=None):
    """Play the round robin; returns ``round_robin``'s dict."""
    args = args or get_parser().parse_known_args()[0]
    import torch

    from gobblet_rl_torch import zoo
    from gobblet_rl_torch.eval import tournament
    from gobblet_rl_torch.policies import value_search

    dev = torch.device(args.device)
    policies = {name: build_policy(name) for name in args.agents}
    for name in args.zoo:
        policies[name] = zoo.policy(name, device=dev)
    for name in args.zoo_search:
        policies[f"{name}+search2"] = value_search.zoo_search_policy(name, device=dev)

    if args.az_checkpoint:
        from gobblet_rl_torch.train import alphazero
        from gobblet_rl_torch.train import checkpoint as ckpt

        config = alphazero.AZConfig(model=args.az_model, num_envs=args.az_num_envs)
        st = alphazero.init_alphazero(config, torch.Generator(device=dev).manual_seed(0))
        if ckpt.restore_az(args.az_checkpoint, st) is None:
            raise SystemExit(f"no checkpoint in {args.az_checkpoint}")
        policies["alphazero"] = alphazero.az_policy(st.net, num_sims=args.az_sims)

    if args.dqn_checkpoint:
        from gobblet_rl_torch.train import checkpoint as ckpt
        from gobblet_rl_torch.train import dqn

        config = dqn.DQNConfig(hidden_sizes=tuple(args.dqn_hidden_sizes),
                               dueling=args.dqn_dueling)
        ts = dqn.init_train_state(config, dqn.make_net(config, dev),
                                  torch.Generator(device=dev).manual_seed(0))
        restored, _ = ckpt.restore(args.dqn_checkpoint, ts)
        if restored is None:
            raise SystemExit(f"no checkpoint in {args.dqn_checkpoint}")
        policies["dqn"] = tournament.dqn_policy(restored.net)

    res = tournament.round_robin(policies, num_games=args.games, seed=args.seed, device=dev)
    if args.json:
        print(json.dumps(res))
        return res

    standings = sorted(res["standings"].items(), key=lambda kv: -kv[1]["elo"])
    print(f"{'agent':<16} {'elo':>7} {'wins':>6} {'losses':>7}")
    for name, row in standings:
        print(f"{name:<16} {row['elo']:>7.1f} {row['wins']:>6} {row['losses']:>7}")
    print()
    for pair, match in res["pairs"].items():
        print(f"{pair}: {match['wins']}-{match['losses']} (undecided {match['undecided']})")
    return res


if __name__ == "__main__":
    main()
