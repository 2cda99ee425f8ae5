"""The defense term in the torch port's trainers: a few bank-weighted
iterations of PPO and of DQN raise the argmax policy's agreement with the
solver's labels on the bank they train on (the twins of
tests/test_defense.py:62,96).  The bank is deterministic in the seed, so
the test rebuilds the trainer's own."""

import numpy as np
import pytest
import torch

from gobblet_rl_torch.native import engine as tengine
from gobblet_rl_torch.train import defense as tdefense
from gobblet_rl_torch.train import dqn as tdqn
from gobblet_rl_torch.train import ppo as tppo
from tests.torch_parity import CPU


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes on a few cores, where torch's thread pools would oversubscribe
    them and small ops slow down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def release_table():
    yield
    tengine.solve_tt_clear()


def agreement(net, bank):
    """Share of the bank's rows where the masked argmax is the label."""
    with torch.no_grad():
        out = net(torch.from_numpy(bank["obs"]))
    out = out[0] if isinstance(out, tuple) else out
    pred = torch.where(torch.from_numpy(bank["mask"]), out, -1e9).argmax(-1).numpy()
    return float((pred == bank["action"]).mean())


def test_ppo_defense_term_trains_toward_labels():
    config = tppo.PPOConfig(
        shared_policy=True, learner_player="both", opponent="random", defense_bc_weight=5.0,
        defense_bank_games=8, defense_bank_depth=12, num_envs=32, segment_len=8,
        minibatches=2, epochs_per_iter=2, iterations=12, hidden_sizes=(32, 32))
    bank = tdefense.generate_defense_bank(num_games=8, seed=config.seed, depth=12, device=CPU)
    before = agreement(tppo.init_ppo(config, torch.Generator().manual_seed(config.seed)).nets[0],
                       bank)
    st, hist = tppo.train(config, device=CPU)
    after = agreement(st.nets[0], bank)
    assert after > before and after >= 0.2, (before, after)
    assert all(np.isfinite(h["loss"]) for h in hist)


def test_dqn_defense_term_trains_toward_labels():
    config = tdqn.DQNConfig(
        opponent="random", defense_bc_weight=5.0, defense_bank_games=8, defense_bank_depth=12,
        lr=1e-3, buffer_size=2048, epoch=6, step_per_epoch=6, segment_len=4,
        update_per_collect=4, batch_size=64, num_envs=32, hidden_sizes=(32, 32))
    bank = tdefense.generate_defense_bank(num_games=8, seed=config.seed, depth=12, device=CPU)
    gen = torch.Generator().manual_seed(config.seed)
    before = agreement(tdqn.init_train_state(config, tdqn.make_net(config, CPU), gen).net, bank)
    ts, hist = tdqn.train(config, device=CPU)
    after = agreement(ts.net, bank)
    assert after > before and after >= 0.2, (before, after)
    assert all(np.isfinite(h["loss"]) for h in hist)
