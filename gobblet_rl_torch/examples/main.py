"""Browser/desktop demo loop: greedy against greedy with randomized openings.

Port of the repository's ``main.py`` onto the port's host surface: the
same asyncio pump (one ``await asyncio.sleep(0)`` a ply, which keeps a
browser runtime such as pygbag's responsive) drives the wrapped
``gobblet_v1`` env with the host greedy.  Host only: it runs no tensor
code.

    python -m gobblet_rl_torch.examples.main --render_mode text --seed 9 --games 1 --depth 1
"""

import argparse
import asyncio
import time

import numpy as np

from gobblet_rl_torch import gobblet_v1
from gobblet_rl_torch.policies.greedy import GreedyGobbletPolicy
from gobblet_rl_torch.policies.random_policy import random_admissible_action


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--render_mode", type=str, default="human",
                        choices=["human", "rgb_array", "text", "text_full"])
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--depth", type=int, default=2, choices=[1, 2, 3])
    parser.add_argument("--games", type=int, default=3,
                        help="number of games (0 = loop forever, browser mode)")
    parser.add_argument("--move-delay", type=float, default=None,
                        help="seconds between moves (default: 0.25 on human)")
    return parser.parse_known_args(argv)[0]


async def play_games(env, policies, games: int, move_delay: float) -> None:
    """The pump: one cooperative yield a ply."""
    played = 0
    while games == 0 or played < games:
        env.reset()
        env.render()
        ply = 0
        for agent in env.agent_iter():
            obs, reward, term, trunc, info = env.last()
            if term or trunc:
                env.step(None)
                continue
            if ply < 2:  # a randomized opening, for variety
                action = random_admissible_action(obs["action_mask"])
            else:
                action = int(policies[agent].compute_action(obs["observation"],
                                                            obs["action_mask"]))
            if move_delay:
                time.sleep(move_delay)
            env.step(action)
            await asyncio.sleep(0)  # keep it 0: yields to the browser loop
            ply += 1
        played += 1


async def main(argv=None) -> None:
    args = parse_args(argv)
    if args.seed is not None:
        np.random.seed(args.seed)
    env = gobblet_v1.env(render_mode=args.render_mode, args=args)
    policies = {a: GreedyGobbletPolicy(depth=args.depth) for a in ["player_1", "player_2"]}
    delay = args.move_delay
    if delay is None:
        delay = 0.25 if args.render_mode == "human" else 0.0
    await play_games(env, policies, args.games, delay)
    env.close()


if __name__ == "__main__":
    asyncio.run(main())
