"""Desktop demo loop: random against random.

Port of the repository's ``main_random.py`` onto the port's host surface.
Host only: it runs no tensor code.

    python -m gobblet_rl_torch.examples.main_random --render_mode text --seed 3
"""

import argparse
import time

import numpy as np

from gobblet_rl_torch import gobblet_v1
from gobblet_rl_torch.policies.random_policy import random_admissible_action


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--render_mode", type=str, default="human",
                        choices=["human", "rgb_array", "text", "text_full"])
    parser.add_argument("--seed", type=int, default=None)
    args = parser.parse_known_args(argv)[0]
    if args.seed is not None:
        np.random.seed(args.seed)

    env = gobblet_v1.env(render_mode=args.render_mode, args=args)
    env.reset()
    for agent in env.agent_iter():
        obs, reward, term, trunc, _ = env.last()
        if term or trunc:
            env.step(None)
            continue
        if args.render_mode == "human":
            time.sleep(0.25)
        env.step(random_admissible_action(obs["action_mask"]))
    env.close()


if __name__ == "__main__":
    main()
