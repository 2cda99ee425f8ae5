"""Checkpoints and exact resume of the torch DQN trainer
(train/checkpoint.py and ``dqn.train(checkpoint_dir=, full_resume_dir=)``),
twins of the JAX package's resume tests: a run preempted and relaunched
ends bit-identical to an uninterrupted one."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from gobblet_rl_torch.train import checkpoint as ckpt
from gobblet_rl_torch.train import dqn

CPU = torch.device("cpu")


def small(**kw):
    base = dict(buffer_size=1024, epoch=1, step_per_epoch=2, segment_len=4,
                update_per_collect=1, batch_size=64, num_envs=32, opponent="random",
                hidden_sizes=(32, 32))
    base.update(kw)
    return dqn.DQNConfig(**base)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes on a few cores, where torch's thread pools would oversubscribe
    them and small ops slow down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_same_params(a, b):
    for net in ("net", "target_net", "opponent_net"):
        for (name, x), y in zip(getattr(a, net).state_dict().items(),
                                getattr(b, net).state_dict().values()):
            assert torch.equal(x, y), f"{net}.{name}"


def test_full_resume_roundtrip(tmp_path):
    config = small()
    d = str(tmp_path / "full")
    ts1, _ = dqn.train(config, full_resume_dir=d, device=CPU)
    # a longer schedule continues from the stored epoch counter
    ts2, hist2 = dqn.train(dataclasses.replace(config, epoch=2), full_resume_dir=d, device=CPU)
    assert len(hist2) == 1 and hist2[0]["epoch"] == 1
    assert ts2.grad_steps == 2 * ts1.grad_steps
    # relaunching the completed schedule restores and trains nothing
    ts3, hist3 = dqn.train(dataclasses.replace(config, epoch=2), full_resume_dir=d, device=CPU)
    assert hist3 == [] and ts3.grad_steps == ts2.grad_steps
    assert_same_params(ts3, ts2)


def test_full_resume_preemption_equivalence(tmp_path):
    """Preempted after epoch 1 of 2 and relaunched with the 2-epoch
    schedule: bit-identical nets, optimizer and counters."""
    base = small(epoch=2)
    straight, _ = dqn.train(base, device=CPU)
    d = str(tmp_path / "preempt")
    dqn.train(dataclasses.replace(base, epoch=1), full_resume_dir=d, device=CPU)
    resumed, hist = dqn.train(base, full_resume_dir=d, device=CPU)
    assert [h["epoch"] for h in hist] == [1]
    assert resumed.grad_steps == straight.grad_steps
    assert_same_params(resumed, straight)
    for s, r in zip(straight.optimizer.state.values(), resumed.optimizer.state.values()):
        assert all(torch.equal(s[k], r[k]) for k in s)


class _Preempt:
    """A logger that dies when epoch 2 is logged: a real preemption, after
    the work of the epoch and before its resume point."""

    def __init__(self):
        self.n = 0

    def log(self, record):
        self.n += 1
        if self.n >= 2:
            raise RuntimeError("preempted")


def test_full_resume_mixed_opponent_rng(tmp_path):
    """The mixed opponent's numpy generator is part of the resume point:
    the relaunched run continues with the same opponent draws."""
    two = small(epoch=2, opponent="mixed", greedy_depth=1, seed=7)
    straight, _ = dqn.train(two, device=CPU)
    d = str(tmp_path / "mixed")
    with pytest.raises(RuntimeError, match="preempted"):
        dqn.train(two, full_resume_dir=d, logger=_Preempt(), device=CPU)
    assert ckpt.latest_step(d) == 0
    resumed, hist = dqn.train(two, full_resume_dir=d, device=CPU)
    assert [h["epoch"] for h in hist] == [1]
    assert_same_params(resumed, straight)


def test_generation_handoff_before_resume_point(tmp_path):
    """The self-play hand-off happens before the resume point is written:
    the saved opponent is the learner of the finished generation."""
    d = str(tmp_path / "gen")
    ts, _ = dqn.train(small(opponent="self"), full_resume_dir=d, device=CPU)
    payload, step = ckpt.restore_payload(d)
    assert step == 0
    state = payload["train_state"]
    for name, p in state["net"].items():
        assert torch.equal(state["opponent_net"][name], p)
        assert torch.equal(p, ts.net.state_dict()[name])


def test_missing_meta_raises(tmp_path):
    d = str(tmp_path / "nometa")
    dqn.train(small(), full_resume_dir=d, device=CPU)
    os.remove(os.path.join(d, "meta-0.json"))
    with pytest.raises(RuntimeError, match="meta-0.json"):
        dqn.train(small(epoch=2), full_resume_dir=d, device=CPU)


def test_meta_written_before_payload(tmp_path, monkeypatch):
    d = str(tmp_path / "order")
    seen = []
    real_save = torch.save

    def spy(obj, path):
        seen.append(os.path.exists(os.path.join(d, "meta-5.json")))
        real_save(obj, path)

    monkeypatch.setattr(ckpt.torch, "save", spy)
    ckpt.save_payload(d, {"x": torch.arange(3)}, step=5, meta={"a": 1})
    assert seen == [True]
    assert ckpt.load_meta(d, 5) == {"a": 1}
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]


def test_keeps_newest_three(tmp_path):
    d = str(tmp_path / "keep")
    for step in (1, 5, 9, 13, 20):
        ckpt.save_payload(d, {"step": step, "x": torch.full((2,), step)}, step,
                          meta={"step": step})
    assert ckpt.latest_step(d) == 20
    assert sorted(os.listdir(d)) == sorted(
        [f"ckpt-{s}.pt" for s in (9, 13, 20)] + [f"meta-{s}.json" for s in (9, 13, 20)])
    payload, step = ckpt.restore_payload(d, step=9)
    assert step == 9 and payload["step"] == 9 and torch.equal(payload["x"], torch.full((2,), 9))
    assert ckpt.restore_payload(str(tmp_path / "empty")) == (None, None)
    assert ckpt.latest_step(str(tmp_path / "empty")) is None


def test_checkpoint_roundtrip(tmp_path):
    config = small()
    ts = dqn.init_train_state(config, dqn.make_net(config, CPU), torch.Generator().manual_seed(0))
    ts.grad_steps = 7
    ckpt.save(str(tmp_path / "ck"), ts, step=7)
    fresh = dqn.init_train_state(config, dqn.make_net(config, CPU),
                                 torch.Generator().manual_seed(1))
    restored, step = ckpt.restore(str(tmp_path / "ck"), fresh)
    assert step == 7 and restored.grad_steps == 7
    assert_same_params(restored, ts)

    ckpt.save_params(str(tmp_path / "policy.pt"), ts.net)
    other = dqn.make_net(config, CPU)
    ckpt.load_params(str(tmp_path / "policy.pt"), other)
    for x, y in zip(other.state_dict().values(), ts.net.state_dict().values()):
        assert torch.equal(x, y)


def test_train_checkpoint_dir_and_payload_format(tmp_path):
    """``checkpoint_dir`` gets the train state at every epoch, keyed by
    gradient steps; every file loads with ``weights_only=True``."""
    c, f = str(tmp_path / "c"), str(tmp_path / "f")
    ts, _ = dqn.train(small(epoch=2), checkpoint_dir=c, full_resume_dir=f, device=CPU)
    assert ckpt.latest_step(c) == ts.grad_steps == 4
    assert sorted(os.listdir(c)) == ["ckpt-2.pt", "ckpt-4.pt"]
    payload, step = ckpt.restore_payload(f)
    assert step == 1 and set(payload) == {"train_state", "env_state", "buffer", "generator"}
    assert payload["buffer"]["filled"] == 2 * 2 * 4 * 32
    assert isinstance(payload["buffer"]["cursor"], int)
    assert payload["generator"].dtype == torch.uint8
    assert np.isfinite(payload["train_state"]["net"]["head.weight"].numpy()).all()
