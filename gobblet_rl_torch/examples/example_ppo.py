"""Self-play PPO entry point of the torch port.

    python -m gobblet_rl_torch.examples.example_ppo --shared-policy --learner-player both \
        --opponent mixed --mixed-weights 0.1 0.6 0.2 0.1 --search-sims 4 --defense-bc-weight 1.0

Port of ``gobblet_rl_tpu/examples/example_ppo.py``, with the same flags;
``--device`` defaults to ``cuda``.  History goes to
``<logdir>/gobblet_rl_torch/ppo/history.jsonl``; ``--checkpoint-dir``
saves a full resume point every iteration (both nets and optimizers, both
env batches, the generator, the league pool and the opponent draw's
generator), so a run relaunched with the same flags continues bit for bit.
"""

from __future__ import annotations

import argparse
import os


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--gamma", type=float, default=0.99)
    parser.add_argument("--iterations", type=int, default=64)
    parser.add_argument("--num-envs", type=int, default=512)
    parser.add_argument("--segment-len", type=int, default=32)
    parser.add_argument("--model", type=str, default="mlp", choices=["mlp", "conv"])
    parser.add_argument("--shared-policy", action="store_true",
                        help="one policy for both players (else one per player)")
    parser.add_argument("--learner-player", type=str, default="0", choices=["0", "1", "both"],
                        help="learner seat(s) in shared-policy mode; 'both' alternates "
                        "even/odd envs")
    parser.add_argument("--opponent", type=str, default="self",
                        choices=["self", "random", "greedy", "pool", "search", "mixed"],
                        help="frozen opponent in the collect (shared-policy mode); 'search' "
                        "is the zoo AlphaZero net behind the Gumbel search; 'mixed' is the "
                        "league of the zoo's ppo_league recipe")
    parser.add_argument("--mixed-weights", type=float, nargs="+", default=[0.1, 0.7, 0.2],
                        metavar="P",
                        help="opponent=mixed: draw weights over (random, greedy, pool[, "
                        "search]), 3 or 4 values")
    parser.add_argument("--search-sims", type=int, default=8,
                        help="Gumbel simulations of the 'search' attacker")
    parser.add_argument("--defense-bc-weight", type=float, default=0.0,
                        help="> 0 adds the solver-supervised defense term (train/defense.py)")
    parser.add_argument("--defense-bank-games", type=int, default=256)
    parser.add_argument("--defense-bank-sides", type=str, default="defense",
                        choices=["defense", "both"])
    parser.add_argument("--logdir", type=str, default="log")
    parser.add_argument("--checkpoint-dir", type=str, default=None,
                        help="full resume points saved every iteration; a run relaunched "
                        "with the same flags resumes bit for bit")
    parser.add_argument("--resume", action="store_true",
                        help="explicit opt-in: with --checkpoint-dir the run resumes from "
                        "the newest step anyway; --resume alone is an error")
    parser.add_argument("--device", type=str, default="cuda")
    return parser


def make_config(args):
    from gobblet_rl_torch.train import ppo

    return ppo.PPOConfig(
        seed=args.seed,
        lr=args.lr,
        gamma=args.gamma,
        iterations=args.iterations,
        num_envs=args.num_envs,
        segment_len=args.segment_len,
        model=args.model,
        shared_policy=args.shared_policy,
        learner_player=(args.learner_player if args.learner_player == "both"
                        else int(args.learner_player)),
        opponent=args.opponent,
        mixed_weights=tuple(args.mixed_weights),
        search_sims=args.search_sims,
        defense_bc_weight=args.defense_bc_weight,
        defense_bank_games=args.defense_bank_games,
        defense_bank_sides=args.defense_bank_sides,
    )


def main(args=None):
    """Train; returns ``(PPOState, history)``."""
    args = args or get_parser().parse_known_args()[0]
    if args.resume and not args.checkpoint_dir:
        raise SystemExit("--resume requires --checkpoint-dir")
    from gobblet_rl_torch.train import ppo
    from gobblet_rl_torch.train.logging import make_logger

    config = make_config(args)
    logger = make_logger(os.path.join(args.logdir, "gobblet_rl_torch", "ppo"), vars(args))
    try:
        st, history = ppo.train(config, logger=logger, full_resume_dir=args.checkpoint_dir,
                                device=args.device)
    finally:
        logger.close()
    print(f"final: {history[-1] if history else 'resumed at end'}")
    return st, history


if __name__ == "__main__":
    main()
