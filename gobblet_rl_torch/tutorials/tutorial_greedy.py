"""Tutorial: watching the greedy agent play.

Port of ``tutorials/GreedyAgent/tutorial_greedy.py``: three rendered
greedy-against-greedy games with the first two moves randomized, so every
game is different.  Host only: it runs no tensor code.

    python -m gobblet_rl_torch.tutorials.tutorial_greedy
"""

import numpy as np

from gobblet_rl_torch import gobblet_v1
from gobblet_rl_torch.policies.greedy import GreedyGobbletPolicy
from gobblet_rl_torch.policies.random_policy import random_admissible_action


def main() -> None:
    env = gobblet_v1.env(render_mode="text")
    policies = {a: GreedyGobbletPolicy(depth=2) for a in ["player_1", "player_2"]}

    for game in range(3):
        env.reset()
        np.random.seed(game)
        ply = 0
        for agent in env.agent_iter():
            obs, reward, termination, truncation, info = env.last()
            if termination or truncation:
                print(f"Game {game}: agent {agent} reward {reward}")
                env.step(None)
                continue
            if ply < 2:  # randomize the opening
                action = random_admissible_action(obs["action_mask"])
            else:
                action = int(policies[agent].compute_action(obs["observation"],
                                                            obs["action_mask"]))
            env.step(action)
            ply += 1
    env.close()


if __name__ == "__main__":
    main()
