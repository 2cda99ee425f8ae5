"""Greedy baseline demo: watch greedy against greedy, or play against it.

Port of ``gobblet_rl_tpu/examples/example_greedy.py`` (the reference's
``example_tianshou_greedy.py`` without Tianshou): the framework-free
``GameSession`` drives the wrapped env.  Host only.

    python -m gobblet_rl_torch.examples.example_greedy --render_mode text --depth 1 --seed 2
"""


import argparse

import numpy as np

from gobblet_rl_torch import gobblet_v1
from gobblet_rl_torch.interactive.session import GameSession
from gobblet_rl_torch.policies.greedy import GreedyGobbletPolicy


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument(
        "--depth", type=int, default=2, choices=[1, 2, 3],
        help="Search depth for the greedy agent (example_tianshou_greedy.py:80-86)",
    )
    parser.add_argument(
        "--render_mode", type=str, default="human",
        choices=["human", "rgb_array", "text", "text_full"],
    )
    parser.add_argument("--player", type=int, default=0, choices=[0, 1])
    parser.add_argument("--cpu-players", type=int, default=2, choices=[1, 2])
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--screen-width", type=int, default=640)
    parser.add_argument("--record", action="store_true")
    return parser


def watch(args) -> None:
    env = gobblet_v1.env(render_mode=args.render_mode, args=args)
    policies = {
        agent: GreedyGobbletPolicy(depth=args.depth) for agent in ["player_1", "player_2"]
    }
    session = GameSession(env, policies)
    while not session.episode_rewards:  # session auto-resets on game end
        session.collect(n_step=1, render=0.1 if args.render_mode == "human" else 0.0)
    print(f"Final rewards: {session.episode_rewards}")


def play(args) -> None:
    env = gobblet_v1.env(render_mode="human", args=args)
    recorder = None
    if args.record:
        from gobblet_rl_torch.render.gif import GIFRecorder

        recorder = GIFRecorder()
    cpu = GreedyGobbletPolicy(depth=args.depth)
    session = GameSession(env, {a: cpu for a in ["player_1", "player_2"]})
    manual = gobblet_v1.ManualGobbletPolicy(env, args.player, recorder)

    while not session.episode_rewards:
        agent = env.agent_selection
        obs, _, term, trunc, _ = env.last()
        if term or trunc:
            env.step(None)
            continue
        if agent == env.agents[args.player]:
            action = manual(obs, agent)
            session.collect_result(action)
        else:
            session.collect(n_step=1)
    if recorder is not None:
        recorder.end_recording(env.unwrapped.screen)


def main(args=None):
    args = args or get_parser().parse_known_args()[0]
    if args.seed is not None:
        np.random.seed(args.seed)
    if args.cpu_players == 2:
        watch(args)
    else:
        play(args)


if __name__ == "__main__":
    main()
