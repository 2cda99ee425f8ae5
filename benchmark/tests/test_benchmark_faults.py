"""With the timed path broken underneath, a run reports ``correct`` false.

Each test skips the look for a card, drives the rest of a run on the CPU
at a tiny size, and plants one fault in the program: a step that leaves
the parameters unchanged; the loss over half of each minibatch; an
answer altered where it is produced (the greedy's reply, the ring's
n-step fold, the agent's move)."""

import pytest
import torch

from benchmark.tests import checkout


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return checkout.make(tmp_path_factory.mktemp("checkout"), cells=("dqn_greedy.recipe",))


def run_false(tiny, cell, name=None):
    rc, out, err = checkout.run_cell(tiny, cell, seed=2**34 + 17)
    assert rc == 0, err
    line = checkout.last_line(out)
    assert line["correct"] is False, line["checks"]
    if name is not None:
        check = line["checks"][name]
        assert check["value"] > check["limit"]
    return line


@pytest.mark.parametrize("cell", ["dqn_greedy.recipe", "dqn_greedy.random-2m"])
def test_unchanged_state(tiny, cell, monkeypatch):
    from gobblet_rl_torch.train import dqn

    original = dqn.update

    def update(config, ts, batch, *args, **kwargs):
        saved = [p.detach().clone() for p in ts.net.parameters()]
        loss = original(config, ts, batch, *args, **kwargs)
        with torch.no_grad():
            for p, s in zip(ts.net.parameters(), saved):
                p.copy_(s)
        return loss

    monkeypatch.setattr(dqn, "update", update)
    run_false(tiny, cell, "change_gap")


@pytest.mark.parametrize("cell", ["dqn_greedy.recipe", "dqn_greedy.random-2m"])
def test_half_batch(tiny, cell, monkeypatch):
    from gobblet_rl_torch.train import dqn

    original = dqn.update

    def update(config, ts, batch, *args, **kwargs):
        half = batch[0].shape[0] // 2
        return original(config, ts, tuple(x[:half] for x in batch), *args, **kwargs)

    monkeypatch.setattr(dqn, "update", update)
    run_false(tiny, cell)


def test_greedy_reply_altered(tiny, monkeypatch):
    """The opponent plays a uniformly drawn legal move, not the greedy's."""
    from gobblet_rl_torch.ops import batched_core as bc
    from gobblet_rl_torch.policies import greedy_jax

    def random_reply(generator, board, current, depth=2, gumbel=None):
        return bc.sample_random_lm(generator, bc.legal_mask_planes(board, current))

    monkeypatch.setattr(greedy_jax, "greedy_actions", random_reply)
    run_false(tiny, "dqn_greedy.recipe", "bad_transitions")


def test_fold_altered(tiny, monkeypatch):
    """The ring's n-step fold forgets the discount."""
    from gobblet_rl_torch.train import replay

    original = replay._fold_scalars
    monkeypatch.setattr(replay, "_fold_scalars",
                        lambda reward, done, n, gamma, s: original(reward, done, n, 1.0, s))
    run_false(tiny, "dqn_greedy.random-2m", "bad_transitions")


def test_move_altered(tiny, monkeypatch):
    """The agent plays its worst legal move."""
    from gobblet_rl_torch.eval import tournament

    def worst(q, mask):
        return torch.where(mask.to(torch.bool), -q, -torch.inf).argmax(-1).to(torch.int32)

    monkeypatch.setattr(tournament, "masked_argmax", worst)
    run_false(tiny, "dqn_greedy.play-b1", "q_gap")
