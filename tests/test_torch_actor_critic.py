"""Port parity for the actor-critic nets: ConvActorCritic and
MLPActorCritic through the flax converter, the masked helpers, and the
generator init — gobblet_rl_torch against gobblet_rl_tpu on the CPU.

Tolerances: float32 outputs within atol 1e-5 (the frameworks sum the
convolutions and products in different orders); bfloat16 outputs within
2e-2 of max |output| (bf16 keeps 8 bits of mantissa and the frameworks
round at different places, ROADMAP §C).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gobblet_rl_torch.models import actor_critic as tac
from gobblet_rl_torch.models.convert import actor_critic_params_from_flax
from gobblet_rl_tpu.models import actor_critic as jac

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes on a few cores, where torch's thread pools would oversubscribe
    them and small ops slow down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def random_obs(n, seed):
    return (np.random.default_rng(seed).random((n, 117)) < 0.2).astype(np.int8)


def nets(model, dtype, seed=0, channels=16, blocks=2, hidden=(32, 32)):
    """(flax net, numpy params, torch twin) of one architecture."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    if model == "conv":
        jnet = jac.ConvActorCritic(channels=channels, blocks=blocks, dtype=jdt)
        tnet = tac.ConvActorCritic(channels=channels, blocks=blocks, dtype=tdt, device=CPU)
    else:
        jnet = jac.MLPActorCritic(hidden_sizes=hidden, dtype=jdt)
        tnet = tac.MLPActorCritic(hidden_sizes=hidden, dtype=tdt, device=CPU)
    params = jnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, 117), jnp.int8))
    params = jax.tree.map(np.asarray, params)
    # non-zero biases, so a mislaid bias shows
    params = jax.tree.map(lambda x: x + 0.01 * np.arange(x.size, dtype=np.float32).reshape(x.shape)
                          / x.size, params)
    tnet.load_state_dict(actor_critic_params_from_flax(params, model))
    return jnet, params, tnet


@pytest.mark.parametrize("model", ["conv", "mlp"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_net_matches_flax(model, dtype):
    jnet, params, tnet = nets(model, dtype)
    obs = random_obs(64, 1)
    want_l, want_v = (np.asarray(x) for x in jnet.apply(params, jnp.asarray(obs)))
    with torch.no_grad():
        got_l, got_v = (x.numpy() for x in tnet(torch.from_numpy(obs)))
    assert got_l.dtype == np.float32 and got_l.shape == (64, 54) and got_v.shape == (64,)
    for got, want in ((got_l, want_l), (got_v, want_v)):
        atol = 1e-5 if dtype == "f32" else 2e-2 * np.abs(want).max()
        np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_conv_layout_with_a_non_symmetric_kernel():
    """One conv tap and one head weight set by hand: the HWIO -> OIHW
    transpose and the NHWC flatten must put them where flax does."""
    jnet, params, tnet = nets("conv", "f32", channels=4, blocks=1)
    params = jax.tree.map(np.zeros_like, params)
    # Conv_0: input channel 2 at tap (h=0, w=1) -> output channel 3
    params["params"]["Conv_0"]["kernel"][0, 1, 2, 3] = 1.0
    # Dense_0 (logits) reads the flattened (h, w, c) feature of cell
    # (h=1, w=2), channel 3 (Conv_1/Conv_2 are zero, so x = relu(x + 0))
    params["params"]["Dense_0"]["kernel"][(1 * 3 + 2) * 4 + 3, 7] = 1.0
    tnet.load_state_dict(actor_critic_params_from_flax(params, "conv"))
    obs = np.zeros((2, 117), np.int8)
    # (channel, cell) order: channel 2, cell (h=0, w=2) feeds tap (0, 1)
    # of output cell (1, 2) under "SAME" padding
    obs[0, 2 * 9 + 0 * 3 + 2] = 1
    obs[1, 2 * 9 + 2 * 3 + 0] = 1          # a cell that feeds no such tap
    want = np.asarray(jnet.apply(params, jnp.asarray(obs))[0])
    with torch.no_grad():
        got = tnet(torch.from_numpy(obs))[0].numpy()
    np.testing.assert_array_equal(got, want)
    assert want[0, 7] == 1.0 and want[1, 7] == 0.0


def test_converter_shapes_and_errors():
    _, params, _ = nets("conv", "f32", channels=8, blocks=2)
    sd = actor_critic_params_from_flax(params, "conv")
    assert sd["convs.0.weight"].shape == (8, 13, 3, 3)
    assert sd["convs.4.weight"].shape == (8, 8, 3, 3)
    assert sd["logits.weight"].shape == (54, 72) and sd["value.weight"].shape == (1, 72)
    np.testing.assert_array_equal(sd["convs.1.weight"].numpy(),
                                  params["params"]["Conv_1"]["kernel"].transpose(3, 2, 0, 1))
    _, mparams, _ = nets("mlp", "f32", hidden=(16, 8))
    msd = actor_critic_params_from_flax(mparams, "mlp")
    assert [msd[k].shape for k in ("hidden.0.weight", "hidden.1.weight", "logits.weight",
                                   "value.weight")] == [(16, 117), (8, 16), (54, 8), (1, 8)]
    with pytest.raises(ValueError):
        actor_critic_params_from_flax(params, "mlp")
    with pytest.raises(ValueError):
        actor_critic_params_from_flax(mparams, "conv")
    with pytest.raises(ValueError):
        actor_critic_params_from_flax(mparams, "resnet")


def test_masked_logits_and_logp_entropy_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(32, 54)).astype(np.float32) * 3
    mask = rng.random((32, 54)) < 0.4
    mask[0] = False                                        # a row with nothing legal
    actions = rng.integers(0, 54, 32).astype(np.int32)
    ml = tac.masked_logits(torch.from_numpy(logits), torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(ml, np.asarray(jac.masked_logits(logits, mask)))
    assert (ml[0] == -1e9).all()
    want = [np.asarray(x) for x in jac.logp_entropy(logits, mask, actions)]
    got = [x.numpy() for x in tac.logp_entropy(torch.from_numpy(logits), torch.from_numpy(mask),
                                               torch.from_numpy(actions))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-6)


def test_sample_masked_statistics():
    """Frequencies over 20,000 draws follow the masked softmax (within 4
    standard errors), no illegal action is drawn, and the returned
    log-probabilities are those of the drawn actions."""
    rng = np.random.default_rng(4)
    logits = np.tile(rng.normal(size=(1, 54)).astype(np.float32), (20000, 1))
    mask = np.tile(rng.random((1, 54)) < 0.3, (20000, 1))
    a, logp = tac.sample_masked(torch.Generator().manual_seed(0), torch.from_numpy(logits),
                                torch.from_numpy(mask))
    a, logp = a.numpy(), logp.numpy()
    assert a.dtype == np.int32 and mask[0, a].all()
    p = np.exp(np.asarray(jax.nn.log_softmax(np.where(mask[0], logits[0], -1e9))))
    freq = np.bincount(a, minlength=54) / len(a)
    assert (np.abs(freq - p) <= 4 * np.sqrt(p * (1 - p) / len(a)) + 1e-9).all()
    np.testing.assert_allclose(logp, np.log(p[a]), atol=1e-5)


@pytest.mark.parametrize("model", ["conv", "mlp"])
def test_init_from_generator_is_reproducible(model):
    def make(seed):
        net = (tac.ConvActorCritic(channels=8, blocks=1, device=CPU) if model == "conv"
               else tac.MLPActorCritic(hidden_sizes=(16,), device=CPU))
        net.reset_parameters(torch.Generator().manual_seed(seed))
        return net
    a, b, c = make(0), make(0), make(1)
    for (name, pa), pb, pc in zip(a.state_dict().items(), b.state_dict().values(),
                                  c.state_dict().values()):
        assert torch.equal(pa, pb), name
        if name.endswith("weight"):
            assert not torch.equal(pa, pc)
            # LeCun truncated normal: |w| <= 2 std, std = 1/sqrt(fan_in)/0.8796
            std = (1 / np.sqrt(pa[0].numel())) / 0.87962566103423978
            assert float(pa.abs().max()) <= 2 * std + 1e-6
            assert float(pa.std()) > 0.5 * std
        else:
            assert not pa.any()
