"""Record a human-vs-random game to ``game.gif``.

Port of ``gobblet_rl_tpu/examples/example_record_game.py``.  Host only: it
needs a pygame window and a human at the mouse.
"""


import argparse

import numpy as np

from gobblet_rl_torch import gobblet_v1
from gobblet_rl_torch.policies.random_policy import random_admissible_action
from gobblet_rl_torch.render.gif import GIFRecorder


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--player", type=int, default=0, choices=[0, 1])
    parser.add_argument("--out", type=str, default="game.gif")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--screen-width", type=int, default=640)
    return parser


def main(args=None):
    args = args or get_parser().parse_known_args()[0]
    if args.seed is not None:
        np.random.seed(args.seed)

    env = gobblet_v1.env(render_mode="human", args=args)
    env.reset()
    recorder = GIFRecorder(out_file=args.out)
    manual = gobblet_v1.ManualGobbletPolicy(env, args.player, recorder)

    for agent in env.agent_iter():
        observation, reward, termination, truncation, info = env.last()
        if termination or truncation:
            env.step(None)
            recorder.end_recording(env.unwrapped.screen)
            continue
        if agent == env.agents[args.player]:
            action = manual(observation, agent)
        else:
            action = random_admissible_action(observation["action_mask"])
        env.step(int(action))
        recorder.capture_frame(env.unwrapped.screen)


if __name__ == "__main__":
    main()
