"""AlphaZero self-play training and watch entry point of the torch port.

    python -m gobblet_rl_torch.examples.example_alphazero --search gumbel --num-sims 32

Port of ``gobblet_rl_tpu/examples/example_alphazero.py``, with the same
flags; ``--device`` defaults to ``cuda``.  History goes to
``<logdir>/gobblet_rl_torch/alphazero/history.jsonl``;
``--checkpoint-dir`` saves and resumes the net, optimizer and env batch,
``--full-resume-dir`` also the generator, so a preempted run relaunched
with the same flags continues bit for bit.  After training, the search
agent plays ``--eval-games`` games against random, greedy-1 and greedy-2,
and with ``--eval-alphabeta-depth > 0`` against the native alpha-beta
expert at that depth.

``--watch`` skips training and renders one game of the search agent
(``--zoo``, ``--checkpoint-dir`` or a fresh net; PUCT at ``--eval-sims``
simulations on ``--device``) against the greedy, alpha-beta or random
``--opponent`` on the host AEC env.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from gobblet_rl_torch.device import resolve_device
from gobblet_rl_torch.policies.greedy import board_from_observation
from gobblet_rl_torch.search import MCTSConfig, mcts_policy


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--lr", type=float, default=2e-3)
    parser.add_argument("--iterations", type=int, default=32)
    parser.add_argument("--num-envs", type=int, default=256)
    parser.add_argument("--num-sims", type=int, default=64)
    parser.add_argument("--segment-len", type=int, default=48)
    parser.add_argument("--temp-moves", type=int, default=8)
    parser.add_argument("--search", type=str, default="puct", choices=["puct", "gumbel"],
                        help="gumbel (sequential halving) needs ~2-4x fewer sims per move "
                        "than puct")
    parser.add_argument("--max-considered", type=int, default=16,
                        help="gumbel: initial root candidate count")
    parser.add_argument("--model", type=str, default="conv", choices=["conv", "mlp"])
    parser.add_argument("--logdir", type=str, default="log")
    parser.add_argument("--checkpoint-dir", type=str, default=None,
                        help="save/resume the net, optimizer and env batch every iteration")
    parser.add_argument("--full-resume-dir", type=str, default=None,
                        help="exact preemption resume: also checkpoints the generator, so "
                        "an interrupted run reproduces the uninterrupted one bit for bit")
    parser.add_argument("--eval-games", type=int, default=256,
                        help="post-training tournament games vs each baseline (0 to skip)")
    parser.add_argument("--eval-sims", type=int, default=128)
    parser.add_argument("--watch", default=False, action="store_true",
                        help="skip training; render one game of the (loaded or fresh) agent "
                        "vs --opponent on the AEC env")
    parser.add_argument("--render_mode", type=str, default="text",
                        choices=["human", "text", "text_full", "rgb_array"])
    parser.add_argument("--opponent", type=str, default="greedy",
                        choices=["greedy", "random", "alphabeta"])
    parser.add_argument("--eval-alphabeta-depth", type=int, default=0,
                        help="if > 0, also evaluate vs the native alpha-beta expert at this "
                        "depth")
    parser.add_argument("--agent-id", type=int, default=1, choices=[1, 2],
                        help="which seat the search agent takes in --watch")
    parser.add_argument("--zoo", type=str, default="",
                        help="--watch with a committed zoo entry (e.g. alphazero_gumbel32)")
    parser.add_argument("--device", type=str, default="cuda")
    return parser


class SearchAgentPolicy:
    """Host-env adapter: ``compute_action(obs (3, 3, 13), mask[54])`` by the
    noise-free PUCT search at B=1 on ``device`` (``None``: the CUDA card,
    or raise), ``GameSession``-compatible like ``GreedyGobbletPolicy``.
    ``net`` is moved to ``device``.  At the default temperature 0 the move
    is deterministic; the generator seeded with ``seed`` feeds any draw."""

    def __init__(self, net, num_sims: int = 128, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self._pol = mcts_policy(net.to(self.device), MCTSConfig(num_sims=num_sims))
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)

    def compute_action(self, obs, mask):
        board, agent = board_from_observation(np.asarray(obs))
        lane_major = torch.from_numpy(board).to(self.device)[..., None]   # [3, 9, 1]
        current = torch.tensor([agent], dtype=torch.int32, device=self.device)
        with torch.no_grad():
            return int(self._pol(self._generator, lane_major, current)[0])


def watch(args, net=None):
    """Render one game: the search agent against the greedy, alpha-beta or
    random opponent on the host AEC env."""
    from gobblet_rl_torch import gobblet_v1
    from gobblet_rl_torch.interactive.session import GameSession
    from gobblet_rl_torch.policies import (
        AlphaBetaGobbletPolicy,
        GreedyGobbletPolicy,
        RandomAdmissiblePolicy,
    )
    from gobblet_rl_torch.train import alphazero
    from gobblet_rl_torch.train import checkpoint as ckpt

    if net is None and args.zoo:
        from gobblet_rl_torch import zoo

        net, _, _ = zoo.load(args.zoo, expect_family="alphazero", device=args.device)
    if net is None:
        generator = torch.Generator(device=args.device)
        generator.manual_seed(args.seed)
        st = alphazero.init_alphazero(alphazero.AZConfig(model=args.model), generator)
        if args.checkpoint_dir:
            ckpt.restore_az(args.checkpoint_dir, st)
        net = st.net
    agent = SearchAgentPolicy(net, num_sims=args.eval_sims, seed=args.seed, device=args.device)
    if args.opponent == "greedy":
        opponent = GreedyGobbletPolicy(depth=2)
    elif args.opponent == "alphabeta":
        opponent = AlphaBetaGobbletPolicy(depth=6, seed=args.seed)
    else:
        opponent = RandomAdmissiblePolicy(seed=args.seed)
    agents = ["player_1", "player_2"]
    seat = agents[args.agent_id - 1]
    env = gobblet_v1.env(render_mode=args.render_mode, args=args)
    session = GameSession(env, {a: (agent if a == seat else opponent) for a in agents})
    while not session.episode_rewards:
        session.collect(n_step=1)
    print(f"Final rewards: {session.episode_rewards}")


def main(args=None):
    """Train (and evaluate); returns ``(AZState, history)``.  With
    ``--watch``, renders one game instead and returns ``None``."""
    args = args or get_parser().parse_known_args()[0]
    if args.watch:
        return watch(args)
    from gobblet_rl_torch.eval import tournament
    from gobblet_rl_torch.train import alphazero
    from gobblet_rl_torch.train.logging import make_logger

    config = alphazero.AZConfig(
        seed=args.seed,
        lr=args.lr,
        iterations=args.iterations,
        num_envs=args.num_envs,
        num_sims=args.num_sims,
        segment_len=args.segment_len,
        temp_moves=args.temp_moves,
        search=args.search,
        max_considered=args.max_considered,
        model=args.model,
    )
    logger = make_logger(os.path.join(args.logdir, "gobblet_rl_torch", "alphazero"), vars(args))
    try:
        st, history = alphazero.train(config, logger=logger, checkpoint_dir=args.checkpoint_dir,
                                      full_resume_dir=args.full_resume_dir, device=args.device)
    finally:
        logger.close()
    print(f"final: {history[-1] if history else 'resumed at end'}")

    if args.eval_games:
        pol = alphazero.az_policy(st.net, num_sims=args.eval_sims)
        opponents = [
            ("random", tournament.random_policy()),
            ("greedy-1", tournament.greedy_policy(1)),
            ("greedy-2", tournament.greedy_policy(2)),
        ]
        if args.eval_alphabeta_depth > 0:
            opponents.append((f"alphabeta-{args.eval_alphabeta_depth}",
                              tournament.alphabeta_policy(args.eval_alphabeta_depth)))
        for name, opp in opponents:
            res = tournament.play_match(pol, opp, num_games=args.eval_games, seed=args.seed,
                                        device=args.device)
            print(f"alphazero vs {name}: {res}")
    return st, history


if __name__ == "__main__":
    main()
