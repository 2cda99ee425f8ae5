"""Interactive AEC loop with 0-2 human players.

Port of ``gobblet_rl_tpu/examples/example_user_input.py``.  The CPU
players are random-admissible, the depth-2 greedy or the native
alpha-beta expert (``--cpu-policy``, ``--cpu-depth``); with
``--cpu-players 2`` no human is needed.  Host only.
"""


import argparse

import numpy as np

from gobblet_rl_torch import gobblet_v1
from gobblet_rl_torch.policies.random_policy import random_admissible_action


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--cpu-players", type=int, default=1, choices=[0, 1, 2],
        help="Number of CPU players (example_user_input.py:16-21)",
    )
    parser.add_argument("--player", type=int, default=0, choices=[0, 1])
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--screen-width", type=int, default=640)
    parser.add_argument(
        "--cpu-policy", type=str, default="random",
        choices=["random", "greedy", "alphabeta"],
        help="CPU opponent: random-admissible (reference behavior), the "
        "depth-2 greedy baseline, or the native alpha-beta expert",
    )
    parser.add_argument("--cpu-depth", type=int, default=None,
                        help="search depth (default: greedy 2, alphabeta 6)")
    return parser


def main(args=None):
    args = args or get_parser().parse_known_args()[0]
    if args.seed is not None:
        np.random.seed(args.seed)

    env = gobblet_v1.env(render_mode="human", args=args)
    env.reset()

    human_agents = []
    if args.cpu_players < 2:
        human_agents.append(env.agents[args.player])
    if args.cpu_players == 0:
        human_agents.append(env.agents[1 - args.player])

    manual = gobblet_v1.ManualGobbletPolicy(env, args.player)

    if args.cpu_policy == "greedy":
        cpu = gobblet_v1.GreedyGobbletPolicy(depth=args.cpu_depth or 2)
        cpu_action = cpu.compute_action
    elif args.cpu_policy == "alphabeta":
        from gobblet_rl_torch.policies import AlphaBetaGobbletPolicy

        cpu = AlphaBetaGobbletPolicy(depth=args.cpu_depth or 6,
                                     seed=args.seed or 0)
        cpu_action = cpu.compute_action
    else:
        def cpu_action(obs, mask):
            return random_admissible_action(mask)

    for agent in env.agent_iter():
        observation, reward, termination, truncation, info = env.last()
        if termination or truncation:
            env.step(None)
            continue
        if agent in human_agents:
            action = manual(observation, agent)
        else:
            action = cpu_action(observation["observation"],
                                observation["action_mask"])
        env.step(int(action))


if __name__ == "__main__":
    main()
