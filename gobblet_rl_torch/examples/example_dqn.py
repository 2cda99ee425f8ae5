"""DQN training, watch and play entry point of the torch port.

    python -m gobblet_rl_torch.examples.example_dqn --opponent greedy --both-seats

Port of ``gobblet_rl_tpu/examples/example_dqn.py``, with the same flags;
``--device`` defaults to ``cuda``.  History goes to
``<logdir>/gobblet_rl_torch/dqn/history.jsonl`` and a checkpoint of the
train state to ``.../dqn/ckpt`` after every epoch; ``--full-resume-dir``
makes a preempted run, relaunched with the same flags, continue bit for
bit.  ``--watch`` renders one game of the Q-net (``--zoo``,
``--resume-path`` or a fresh net, on ``--device``) against the random or
greedy ``--opponent`` on the host AEC env; ``--cpu-players 1`` plays it
against a human through the pygame manual policy (``--record`` writes
``game.gif``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from gobblet_rl_torch.models.mlp import masked_argmax


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--seed", type=int, default=1626)
    parser.add_argument("--eps-test", type=float, default=0.05)
    parser.add_argument("--eps-train", type=float, default=0.1)
    parser.add_argument("--buffer-size", type=int, default=1 << 18)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument(
        "--gamma", type=float, default=0.9, help="a smaller gamma favors earlier win"
    )
    parser.add_argument("--n-step", type=int, default=3)
    parser.add_argument("--target-update-freq", type=int, default=320)
    parser.add_argument("--epoch", type=int, default=50)
    parser.add_argument("--step-per-epoch", type=int, default=64,
                        help="collect iterations per epoch")
    parser.add_argument("--step-per-collect", type=int, default=16,
                        help="learner steps per collect iteration (segment length)")
    parser.add_argument("--update-per-step", type=float, default=0.5,
                        help="gradient steps per collected learner step")
    parser.add_argument("--batch-size", type=int, default=1024)
    parser.add_argument("--hidden-sizes", type=int, nargs="*",
                        default=[128, 128, 128, 128])
    parser.add_argument("--training-num", type=int, default=1024,
                        help="parallel envs in the batched collector")
    parser.add_argument("--test-num", type=int, default=512,
                        help="parallel envs during evaluation")
    parser.add_argument("--logdir", type=str, default="log")
    parser.add_argument("--render", type=float, default=0.1)
    parser.add_argument("--render_mode", type=str, default="human",
                        choices=["human", "rgb_array", "text", "text_full"])
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--self_play", action="store_true")
    parser.add_argument("--self_play_generations", type=int, default=5)
    parser.add_argument("--self_play_greedy", action="store_true",
                        help="first generation trains against the greedy agent")
    parser.add_argument("--cpu-players", type=int, default=2, choices=[1, 2])
    parser.add_argument("--player", type=int, default=0, choices=[0, 1])
    parser.add_argument("--record", action="store_true")
    parser.add_argument("--win-rate", type=float, default=0.6,
                        help="stop criterion: expected winning rate")
    parser.add_argument("--watch", default=False, action="store_true")
    parser.add_argument("--agent-id", type=int, default=2,
                        help="the learned agent plays as the agent_id-th player")
    parser.add_argument("--resume-path", type=str, default="")
    parser.add_argument("--opponent-path", type=str, default="")
    parser.add_argument("--full-resume-dir", type=str, default="",
                        help="exact preemption resume: checkpoints nets + "
                        "optimizer + env batch + replay ring + generator + the "
                        "epoch counter and opponent-draw RNG every epoch; an "
                        "interrupted run relaunched with the same flags "
                        "continues the epoch schedule bit-exactly")
    parser.add_argument("--zoo", type=str, default="",
                        help="watch/play with a committed zoo entry (e.g. "
                        "dqn_greedy) instead of --resume-path")
    parser.add_argument("--both-seats", action="store_true",
                        help="train one net over alternating per-env seats")
    parser.add_argument("--defense-bc-weight", type=float, default=0.0,
                        help="> 0 adds solver-supervised defense distillation "
                        "(train/defense.py)")
    parser.add_argument("--opponent", type=str, default="random",
                        choices=["random", "greedy", "self", "mixed"],
                        help="training opponent; 'mixed' draws random/greedy/"
                             "self per iteration")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--no-double", dest="double", action="store_false",
                        help="disable double-DQN target selection")
    parser.add_argument("--no-dueling", dest="dueling", action="store_false",
                        help="disable the dueling value/advantage head")
    parser.add_argument("--eps-eval", type=float, default=0.0,
                        help="evaluation epsilon (reference tested at 0.05)")
    return parser


def get_args() -> argparse.Namespace:
    return get_parser().parse_known_args()[0]


def make_config(args):
    from gobblet_rl_torch.train.dqn import DQNConfig

    update_per_collect = max(1, int(args.update_per_step * args.step_per_collect))
    return DQNConfig(
        seed=args.seed,
        eps_train=args.eps_train,
        eps_test=args.eps_test,
        buffer_size=args.buffer_size,
        lr=args.lr,
        gamma=args.gamma,
        n_step=args.n_step,
        target_update_freq=args.target_update_freq,
        epoch=args.epoch,
        step_per_epoch=args.step_per_epoch,
        segment_len=args.step_per_collect,
        update_per_collect=update_per_collect,
        batch_size=args.batch_size,
        hidden_sizes=tuple(args.hidden_sizes),
        num_envs=args.training_num,
        learner_player="both" if args.both_seats else args.agent_id - 1,
        opponent=args.opponent,
        double=args.double,
        dueling=args.dueling,
        eps_eval=args.eps_eval,
        defense_bc_weight=args.defense_bc_weight,
    )


def train_agent(args):
    from gobblet_rl_torch.train import dqn
    from gobblet_rl_torch.train.logging import make_logger

    config = make_config(args)
    logdir = os.path.join(args.logdir, "gobblet_rl_torch", "dqn")
    logger = make_logger(logdir, vars(args))
    generations = args.self_play_generations if args.self_play else 1
    if args.self_play:
        config = dataclasses.replace(
            config, opponent="greedy" if args.self_play_greedy else "self"
        )
    try:
        ts, history = dqn.train(config, logger=logger, generations=generations,
                                checkpoint_dir=os.path.join(logdir, "ckpt"),
                                full_resume_dir=args.full_resume_dir or None,
                                device=args.device)
    finally:
        logger.close()
    if history:
        best = max(h["win_rate"] for h in history)
        print(f"best eval win-rate: {best:.3f} (target {args.win_rate})")
    else:
        print("the schedule was already complete: nothing to train")
    return ts, history


class QPolicy:
    """Host-env adapter of a Q-net: ``compute_action(obs (3, 3, 13),
    mask[54])`` is the masked argmax of the Q-values of the observation in
    ``(channel, cell)`` order, the layout the net was trained on."""

    def __init__(self, net):
        self.net = net
        self.device = next(net.parameters()).device

    def compute_action(self, obs, mask):
        flat = np.transpose(np.asarray(obs), (2, 0, 1)).reshape(1, -1)   # (channel, cell)
        with torch.no_grad():
            q = self.net(torch.from_numpy(np.ascontiguousarray(flat, np.int8)).to(self.device))
        mask = torch.from_numpy(np.asarray(mask, bool)).to(self.device)[None]
        return int(masked_argmax(q, mask)[0])


def load_net(args):
    """The Q-net of ``--zoo``, or a fresh one (initialised from seed 0) on
    ``--device`` with ``--resume-path``'s parameters if given."""
    from gobblet_rl_torch.train import checkpoint as ckpt
    from gobblet_rl_torch.train import dqn

    if args.zoo:
        from gobblet_rl_torch import zoo

        return zoo.load(args.zoo, expect_family="dqn", device=args.device)[0]
    net = dqn.make_net(make_config(args), device=args.device)
    generator = torch.Generator(device=args.device)
    generator.manual_seed(0)
    net.reset_parameters(generator)
    if args.resume_path:
        ckpt.load_params(args.resume_path, net)
    return net


def watch(args, net=None):
    """Render a game of the Q-net against its opponent on the host env."""
    from gobblet_rl_torch import gobblet_v1
    from gobblet_rl_torch.interactive.session import GameSession
    from gobblet_rl_torch.policies import GreedyGobbletPolicy, RandomAdmissiblePolicy

    learner = QPolicy(net if net is not None else load_net(args))
    opponent = (GreedyGobbletPolicy(depth=2) if args.opponent == "greedy"
                else RandomAdmissiblePolicy(seed=args.seed))
    agents = ["player_1", "player_2"]
    learner_agent = agents[args.agent_id - 1]
    env = gobblet_v1.env(render_mode=args.render_mode, args=args)
    policies = {a: (learner if a == learner_agent else opponent) for a in agents}
    session = GameSession(env, policies)
    while not session.episode_rewards:  # the session resets itself at the game's end
        session.collect(n_step=1, render=args.render if args.render_mode == "human" else 0)
    print(f"Final rewards: {session.episode_rewards}")


def play(args):
    """A human (``--player``) against the Q-net, through the pygame manual
    policy; ``--record`` writes the game to ``game.gif``."""
    from gobblet_rl_torch import gobblet_v1
    from gobblet_rl_torch.interactive.session import GameSession

    recorder = None
    if args.record:
        from gobblet_rl_torch.render.gif import GIFRecorder

        recorder = GIFRecorder()
    cpu = QPolicy(load_net(args))
    env = gobblet_v1.env(render_mode="human", args=args)
    agents = ["player_1", "player_2"]
    session = GameSession(env, {a: cpu for a in agents})
    manual = gobblet_v1.ManualGobbletPolicy(env, args.player, recorder)
    while not session.episode_rewards:
        obs, _, term, trunc, _ = env.last()
        if term or trunc:
            env.step(None)
            continue
        if env.agent_selection == agents[args.player]:
            session.collect_result(manual(obs, env.agent_selection))
        else:
            session.collect(n_step=1)
    if recorder is not None:
        recorder.end_recording(env.unwrapped.screen)


def main(args=None):
    args = args or get_args()
    if args.watch:
        return watch(args)
    if args.cpu_players == 1:
        return play(args)
    return train_agent(args)


if __name__ == "__main__":
    main()
