"""The port's AlphaZero path against the benchmark's plain reference
(``benchmark/reference/az.py`` and ``az_search.py``), at a small size on
the CPU with seeded random weights and the port's nets in float32.

The net's logits and values; the Gumbel search with an injected root
field (identical actions and visit counts, the target and the root value
within 1e-5); the halving schedule against the port's and the paper's;
the update (loss, clip, AdamW); the self-play segment's rows against the
reference's rules, exactly; the value targets against the reference's
backfill, exactly.
"""

import numpy as np
import pytest
import torch

from benchmark.drivers import az_train
from benchmark.harness import traffic
from benchmark.reference import az as ref_az
from benchmark.reference import az_search, rules
from gobblet_rl_torch.models import actor_critic as ac
from gobblet_rl_torch.ops import batched_core as bc
from gobblet_rl_torch.search import gumbel, gumbel_lm
from gobblet_rl_torch.train import alphazero

CPU = torch.device("cpu")


def conv_net(seed: int, channels: int = 64, blocks: int = 2, dtype=torch.float32):
    """A ``ConvActorCritic`` computing in ``dtype``, with LeCun weights and
    small nonzero biases drawn in float32 and held in ``dtype``, and its
    parameters as the reference's dict."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    net = ac.ConvActorCritic(channels=channels, blocks=blocks, dtype=dtype, device=CPU)
    net.reset_parameters(gen)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    net.to(dtype)
    return net, {k: v.detach().clone() for k, v in net.state_dict().items()}


def positions(seed: int, n: int):
    board, current = traffic.play_positions(seed, n, 40)
    return torch.from_numpy(board), torch.from_numpy(current)


def test_net_matches_reference():
    net, params = conv_net(1)
    board, current = positions(2, 96)
    obs = rules.features(board, current)
    with torch.no_grad():
        logits, value = net(obs.to(torch.int8))
    ref_logits, ref_value = ref_az.forward(params, obs)
    assert torch.allclose(logits, ref_logits, atol=1e-5, rtol=0)
    assert torch.allclose(value, ref_value, atol=1e-5, rtol=0)
    # the reference's own layout: the board's cells are NCHW's 3x3 plane
    assert list(params) == list(ref_az.shapes(64, 2))


@pytest.mark.parametrize("sims", [8, 32])
def test_search_matches_reference(sims):
    net, params = conv_net(5)
    board, current = positions(11, 64)
    gen = torch.Generator()
    gen.manual_seed(3)
    noise = bc.gumbel_field(gen, (64, 54), CPU)
    cfg = gumbel.GumbelConfig(num_sims=sims, max_considered=16)
    action, pi, _, visits, value = gumbel_lm.gumbel_search_lm(
        net, board.permute(1, 2, 0).contiguous(), current, None, cfg,
        noise=noise.t().contiguous())
    search = az_search.Search({"num_sims": sims, "max_considered": 16, "c_visit": cfg.c_visit,
                               "c_scale": cfg.c_scale}, az_search.evaluator(params), CPU)
    ref = search.run(board, current, noise)
    assert (action.numpy() == ref["action"]).all()
    assert (visits.numpy() == ref["visits"]).all()
    assert np.abs(pi.numpy() - ref["pi"]).max() <= 1e-5
    assert np.abs(value.numpy() - ref["value"]).max() <= 1e-5
    # the searches went below the root
    assert ref["advances"].max() >= (2 if sims == 32 else 1)


@pytest.mark.parametrize("sims,m", [(32, 16), (8, 16), (64, 16), (32, 4), (12, 5), (5, 2)])
def test_halving_schedule_is_the_ports(sims, m):
    phase = az_search.phase_table(sims, m)
    assert (phase == gumbel._phase_table(sims, m)).all()
    counts = gumbel._considered_counts(m, int(phase[-1]) + 1)
    assert [az_search.considered_count(m, p) for p in range(len(counts))] == list(counts)


def test_halving_schedule_against_the_papers():
    """The port splits 32 simulations evenly over 4 phases of 16, 8, 4 and
    2 actions; the paper's sequential halving gives each of the 16 one
    visit, then each of 8 one, then each of 4 two, and never reaches 2."""
    ours = [az_search.considered_count(16, p) for p in az_search.phase_table(32, 16)]
    assert ours == [16] * 8 + [8] * 8 + [4] * 8 + [2] * 8
    assert az_search.paper_schedule(32, 16) == [16] * 16 + [8] * 8 + [4] * 8
    assert az_search.paper_schedule(16, 4) == [4] * 8 + [2] * 8


def flat_batch(seed: int, n: int):
    board, current = positions(seed, n)
    gen = torch.Generator()
    gen.manual_seed(seed)
    mask = rules.legal_mask(board, current)
    raw = torch.where(mask, torch.rand((n, 54), generator=gen), 0.0)
    return {"obs": rules.features(board, current).to(torch.int8), "mask": mask,
            "pi": raw / raw.sum(1, keepdim=True),
            "z": torch.rand(n, generator=gen) * 2 - 1,
            "valid": torch.rand(n, generator=gen) < 0.8}


@pytest.mark.parametrize("max_grad_norm", [1.0, 1e3])
def test_update_matches_reference(max_grad_norm):
    """Three updates: the loss of each, the parameters after, with the clip
    active (norm 1) and idle.  Update ``i`` takes the rows
    ``perm[start:start + 32]``, ``start = 32 i mod (96 - 32)``, so the third
    repeats the first.

    The nets compute in float64 (the port's logits are float32): a
    gradient near Adam's eps (1e-8) is float32 rounding noise, and AdamW
    turns it into a parameter gap of up to 2e-5 between any two float32
    summation orders; the float32 reference itself lies 1.9e-5 from its
    float64 result here."""
    config = alphazero.AZConfig(batch_size=32, updates_per_iter=3, max_grad_norm=max_grad_norm)
    net, params = conv_net(7, channels=32, blocks=2, dtype=torch.float64)
    flat = flat_batch(13, 96)
    gen = torch.Generator()
    gen.manual_seed(4)
    perm = torch.randperm(96, generator=gen)
    losses, _, _ = alphazero.make_update_phase(config)(
        net, alphazero.make_optimizer(config, net), flat, perm=perm)
    rcfg = {"lr": config.lr, "betas": (0.9, 0.999), "eps": 1e-8,
            "weight_decay": config.weight_decay, "max_grad_norm": max_grad_norm,
            "value_coef": config.value_coef}
    rows = {k: (v.to(torch.float64) if k == "obs" else v) for k, v in flat.items()}
    batches = [{k: v[perm[(i * 32) % 64:][:32]] for k, v in rows.items()} for i in range(3)]
    # one iteration an update, so each update's loss is reported
    ref_losses, _, ref_params = ref_az.train(params, [[mb] for mb in batches], rcfg)
    assert np.abs(losses.numpy() - np.array(ref_losses)).max() <= 1e-5
    for k, v in net.state_dict().items():
        assert (v - ref_params[k]).abs().max() <= 1e-5, k
    # one iteration of the three minibatches is the same run
    whole = ref_az.train(params, [batches], rcfg)
    assert abs(whole[0][0] - float(losses.mean())) <= 1e-5


def tiny_config(**kw):
    base = dict(search="gumbel_lm", num_envs=12, num_sims=6, segment_len=10, batch_size=16,
                updates_per_iter=2, model="conv", channels=16, blocks=1)
    return alphazero.AZConfig(**{**base, **kw})


def test_segment_rows_follow_the_rules():
    """Two iterations' rows of every lane: obs, mask, player, done, winner,
    the played move legal, pi and v_signed the search's, each root the
    rules' successor of the last."""
    cfg = tiny_config()
    gen = torch.Generator()
    gen.manual_seed(1)
    st = alphazero.init_alphazero(cfg, gen)
    iteration = alphazero.make_train_iteration(cfg)
    probe = az_train.Probe(cfg, st, gen, np.arange(cfg.num_envs))
    for _ in range(2):
        probe.begin()
        probe.after(iteration(st, gen, mark=probe.mark, ply=probe.ply))
    total, kinds = az_train.bad_rows(probe)
    assert total == 0, kinds
    assert int(sum(it["rows"]["done"].sum() for it in probe.iterations)) > 0
    # the hook saw every ply, and its generator states redraw the root field
    assert [len(it["plies"]) for it in probe.iterations] == [cfg.segment_len] * 2
    assert all(p["gen_state"] is not None for it in probe.iterations for p in it["plies"])


def test_ply_hook_off_changes_nothing():
    """The same seed with and without the hook: the same net afterwards."""
    cfg = tiny_config(segment_len=4)
    nets = []
    for hooked in (False, True):
        gen = torch.Generator()
        gen.manual_seed(9)
        st = alphazero.init_alphazero(cfg, gen)
        seen = []
        hook = (lambda t, state, g, out, traj: seen.append(t)) if hooked else None
        alphazero.make_train_iteration(cfg)(st, gen, ply=hook)
        nets.append(st.net.state_dict())
        assert seen == (list(range(4)) if hooked else [])
    assert all(torch.equal(nets[0][k], nets[1][k]) for k in nets[0])


@pytest.mark.parametrize("bootstrap", [False, True])
def test_backfill_matches_assign_outcomes(bootstrap):
    gen = torch.Generator()
    gen.manual_seed(21)
    L, n = 12, 64
    done = torch.rand((L, n), generator=gen) < 0.2
    winner = torch.where(done, torch.where(torch.rand((L, n), generator=gen) < 0.5, 1, -1),
                         0).to(torch.int8)
    player = (torch.arange(L)[:, None] + torch.arange(n)[None]) % 2
    player = player.to(torch.int32)
    boot = torch.rand((L, n), generator=gen) * 2 - 1 if bootstrap else None
    z, valid = alphazero.assign_outcomes(done, winner, player, boot)
    rz, rvalid = ref_az.backfill(done, winner, player, None if boot is None else boot[-1])
    assert torch.equal(valid, rvalid)
    assert torch.equal(torch.where(valid, z, 0.0), torch.where(rvalid, rz, 0.0))
