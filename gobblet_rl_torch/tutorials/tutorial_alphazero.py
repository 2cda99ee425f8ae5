"""Tutorial: train a tiny AlphaZero agent and watch it play.

Port of ``tutorials/AlphaZero/tutorial_alphazero.py``: three self-play and
learning iterations of a small MLP with the Gumbel search (good targets at
very low simulation counts), then a rendered game of the trained net
against the depth-1 greedy.  Sized to finish in about a minute on the CPU;
scale ``num_envs``, ``num_sims`` and ``iterations`` up on the card.

    python -m gobblet_rl_torch.tutorials.tutorial_alphazero [--device cpu]
"""

import argparse

import numpy as np
import torch

from gobblet_rl_torch import gobblet_v1
from gobblet_rl_torch.device import resolve_device
from gobblet_rl_torch.policies.greedy import GreedyGobbletPolicy
from gobblet_rl_torch.search import GumbelConfig, gumbel_search
from gobblet_rl_torch.train import alphazero as az


def train_tiny(device=None):
    """Three iterations on ``device`` (``None``: the card, or raise);
    returns ``(config, AZState)``."""
    config = az.AZConfig(
        num_envs=16, num_sims=12, segment_len=16, search="gumbel",
        max_considered=8, batch_size=64, updates_per_iter=2,
        iterations=3, model="mlp", hidden_sizes=(64, 64),
    )
    generator = torch.Generator(device=resolve_device(device))
    generator.manual_seed(0)
    st = az.init_alphazero(config, generator)
    it = az.make_train_iteration(config)
    for i in range(config.iterations):
        stats = it(st, generator)
        print(
            f"iteration {i}: loss {float(stats['loss']):.3f} "
            f"(policy {float(stats['policy_loss']):.3f}, "
            f"value {float(stats['value_loss']):.3f}), "
            f"episodes {int(stats['episodes'])}"
        )
    return config, st


def watch(config, st, seed: int = 0):
    """One rendered game: the searched net (player 1) against greedy
    depth-1, on the net's device."""
    dev = next(st.net.parameters()).device
    env = gobblet_v1.env(render_mode="text")
    env.reset(seed=seed)
    np.random.seed(seed)
    greedy = GreedyGobbletPolicy(depth=1)
    gcfg = GumbelConfig(num_sims=config.num_sims, max_considered=config.max_considered)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)

    for agent in env.agent_iter():
        obs, reward, term, trunc, info = env.last()
        if term or trunc:
            print(f"agent {agent} reward {reward}")
            env.step(None)
            continue
        if agent == "player_1":
            board = torch.from_numpy(np.asarray(env.unwrapped.board._grid())[None]).to(dev)
            actions = gumbel_search(st.net, board, torch.zeros(1, dtype=torch.int32, device=dev),
                                    generator, gcfg)[0]
            action = int(actions[0])
        else:
            action = int(greedy.compute_action(obs["observation"], obs["action_mask"]))
        env.step(action)
    env.close()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    from gobblet_rl_torch.device import resolve_device

    config, st = train_tiny(resolve_device(args.device))
    watch(config, st)


if __name__ == "__main__":
    main()
