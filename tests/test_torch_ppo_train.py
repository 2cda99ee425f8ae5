"""The torch port's PPO ``train``: the config's validation against JAX's,
the mixed league (its opponent draws equal JAX's), the two-policy mode,
and exact resume of a preempted league run (bit for bit)."""

import dataclasses

import numpy as np
import pytest
import torch

from gobblet_rl_torch.train import checkpoint as ckpt
from gobblet_rl_torch.train import ppo as tppo
from gobblet_rl_tpu.train import ppo as jppo
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


def test_config_validation_matches_jax():
    """tests/test_ppo.py:88,115."""
    for kw, match in ((dict(shared_policy=True, opponent="mixed", mixed_weights=(0.5, 0.5)),
                       "mixed_weights"),
                      (dict(opponent="greedy"), "pure self-play")):
        with pytest.raises(ValueError, match=match):
            jppo.PPOConfig(**kw)
        with pytest.raises(ValueError, match=match):
            tppo.PPOConfig(**kw)
    assert dataclasses.asdict(tppo.PPOConfig()) == dataclasses.asdict(jppo.PPOConfig())
    with pytest.raises(ValueError, match="unknown opponent"):
        tppo.make_opponent_fn(tppo.PPOConfig(shared_policy=True, opponent="nobody"), device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tppo.train(tppo.PPOConfig(iterations=1))


def league_config(**kw):
    base = dict(num_envs=16, segment_len=6, iterations=6, minibatches=2, epochs_per_iter=1,
                shared_policy=True, opponent="mixed", learner_player="both", pool_every=2,
                pool_size=2, hidden_sizes=(32,))
    base.update(kw)
    return base


def test_mixed_league_draws_as_jax():
    """tests/test_ppo.py:102: the 3-weight league.  The legs and the pool
    entries come from ``np.random.default_rng(seed)`` in both packages, so
    the sequence of opponents is JAX's."""
    cfg = league_config()
    _, jhist = jppo.train(jppo.PPOConfig(**cfg))
    st, hist = tppo.train(tppo.PPOConfig(**cfg), device=CPU)
    assert [h["opponent"] for h in hist] == [h["opponent"] for h in jhist]
    assert {h["opponent"] for h in hist} == {"random", "greedy", "self"}
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert all(h["learner"] == "both" and h["episodes"] > 0 for h in hist)
    assert st.nets[0] is st.nets[1]


def test_two_policy_mode_alternates_roles():
    """Non-shared mode: iteration i trains net i % 2 from its own env
    batch, against the other net; both nets move and each batch stays at
    its role's turn."""
    config = tppo.PPOConfig(num_envs=16, segment_len=6, iterations=2, minibatches=2,
                            epochs_per_iter=1, hidden_sizes=(32,))
    gen = torch.Generator().manual_seed(config.seed)
    init = tppo.init_ppo(config, gen)
    before = [tppo.snapshot(n) for n in init.nets]
    st, hist = tppo.train(config, device=CPU)
    assert [h["learner"] for h in hist] == [0, 1]
    assert all(h["opponent"] == "self" for h in hist)
    for net, b in zip(st.nets, before):
        assert any(not torch.equal(v, b[k]) for k, v in net.state_dict().items())
    for role, env in enumerate(st.env_states):
        assert bool((env.current == role).all())


def states_equal(a, b):
    for na, nb in zip(a.nets, b.nets):
        for (name, x), y in zip(na.state_dict().items(), nb.state_dict().values()):
            assert torch.equal(x, y), name
    for ea, eb in zip(a.env_states, b.env_states):
        for x, y in zip(ea, eb):
            assert torch.equal(x, y)
    for oa, ob in zip(a.optimizers, b.optimizers):
        sa, sb = oa.state_dict()["state"], ob.state_dict()["state"]
        assert sa.keys() == sb.keys()
        for k in sa:
            for name in sa[k]:
                assert torch.equal(sa[k][name], sb[k][name]), (k, name)


def test_full_resume_is_bit_identical(tmp_path):
    """tests/test_ppo.py:156: a league run preempted after 2 of 4
    iterations and relaunched through ``full_resume_dir`` ends where the
    uninterrupted run ends, bit for bit, pool and opponent draws included;
    a finished schedule trains nothing; a step without its meta sidecar
    refuses to resume."""
    config = tppo.PPOConfig(**league_config(iterations=4))
    straight, hist = tppo.train(config, device=CPU)
    d = str(tmp_path / "resume")
    tppo.train(dataclasses.replace(config, iterations=2), full_resume_dir=d, device=CPU)
    assert ckpt.latest_step(d) == 1 and ckpt.load_meta(d, 1)["pool_len"] == 2
    resumed, hist2 = tppo.train(config, full_resume_dir=d, device=CPU)
    assert [h["iteration"] for h in hist2] == [2, 3]
    assert hist2 == hist[2:]
    states_equal(straight, resumed)
    _, hist3 = tppo.train(config, full_resume_dir=d, device=CPU)
    assert hist3 == []
    (tmp_path / "resume" / "meta-3.json").unlink()
    with pytest.raises(RuntimeError, match="meta-3.json"):
        tppo.train(config, full_resume_dir=d, device=CPU)


def test_resume_restores_the_pool_on_the_generators_device(tmp_path):
    config = tppo.PPOConfig(**league_config(iterations=2))
    gen = torch.Generator().manual_seed(0)
    st = tppo.init_ppo(config, gen)
    pool = [tppo.snapshot(st.nets[0]), tppo.snapshot(st.nets[0])]
    ckpt.save_ppo(str(tmp_path), st, gen, pool, 0, meta={"pool_len": 2})
    fresh = tppo.init_ppo(config, torch.Generator().manual_seed(5))
    gen2 = torch.Generator()
    got = ckpt.restore_ppo(str(tmp_path), fresh, gen2)
    assert len(got) == 2 and all(torch.equal(got[0][k], v) for k, v in pool[0].items())
    assert torch.equal(gen2.get_state(), gen.get_state())
    states_equal(st, fresh)
