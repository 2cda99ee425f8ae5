"""Watch two random-admissible players: the smallest demo.

Port of ``gobblet_rl_tpu/examples/example_basic.py`` (the reference's basic
example): the same flags and render modes, through the shared
:func:`gobblet_rl_torch.policies.random_policy.random_admissible_action`
sampler and a ``play_random_game`` helper other scripts can import.  Host
only (the AEC env needs ``pettingzoo``).

    python -m gobblet_rl_torch.examples.example_basic --render_mode text --seed 1
"""


import argparse
import time

import numpy as np

from gobblet_rl_torch import gobblet_v1
from gobblet_rl_torch.policies.random_policy import random_admissible_action


def play_random_game(env, *, move_delay: float = 0.0, verbose: bool = True):
    """Drive one full game with uniform-over-mask actions on both sides.

    Returns the final per-agent cumulative rewards dict.
    """
    env.reset()
    env.render()
    final_rewards = {}
    while env.agents:
        agent = env.agent_selection
        obs, reward, terminated, truncated, info = env.last()
        if terminated or truncated:
            final_rewards[agent] = reward
            if verbose:
                print(f"Agent: ({agent}), Reward: {reward}, info: {info}")
            env.step(None)
            continue
        if move_delay:
            time.sleep(move_delay)
        env.step(random_admissible_action(obs["action_mask"]))
    return final_rewards


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "--render_mode",
        default="human",
        choices=["human", "rgb_array", "text", "text_full"],
        help="Choose the rendering mode for the game.",
    )
    parser.add_argument(
        "--seed", type=int, default=None, help="random seed for board and policy"
    )
    parser.add_argument(
        "--debug", action="store_true", help="display extra debugging information"
    )
    parser.add_argument(
        "--screen-width", type=int, default=640,
        help="Width of pygame screen in pixels",
    )
    return parser


def main(args=None):
    args = args or build_parser().parse_known_args()[0]
    if args.seed is not None:
        np.random.seed(args.seed)
    env = gobblet_v1.env(render_mode=args.render_mode, args=args)
    delay = 0.5 if args.render_mode == "human" else 0.0
    play_random_game(env, move_delay=delay)


if __name__ == "__main__":
    main()
