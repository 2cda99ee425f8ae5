"""The policy-value net's 3x3 convs as dense matrix products: the
``ConvActorCritic`` forward and its gradients against the same net written
with ``F.conv2d`` (NCHW, permuted to NHWC before the heads), the dense
weight's taps cell by cell, and a fresh import that builds nothing.

Tolerances: float32 on the CPU, the widest gap over the largest |value|
within 1e-5 (the two forms sum the same products in different orders).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gobblet_rl_torch.models import actor_critic as ac

CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def conv_form(net: ac.ConvActorCritic, obs: torch.Tensor):
    """The net as NCHW convolutions, flattened in NHWC order for the heads."""
    b = obs.shape[0]

    def conv(i, x):
        return F.conv2d(x, *net._cast(net.convs[i]), padding=1)

    x = F.relu(conv(0, obs.reshape(b, 13, 3, 3).to(net.dtype)))
    for k in range(net.blocks):
        h = F.relu(conv(1 + 2 * k, x))
        x = F.relu(x + conv(2 + 2 * k, h))
    return net._heads(x.permute(0, 2, 3, 1).reshape(b, -1))


def random_net(channels, blocks, seed=0):
    """A float32 net with LeCun weights and nonzero biases."""
    net = ac.ConvActorCritic(channels=channels, blocks=blocks, dtype=torch.float32, device=CPU)
    g = torch.Generator().manual_seed(seed)
    net.reset_parameters(g)
    with torch.no_grad():
        for layer in (*net.convs, net.logits, net.value):
            layer.bias.copy_(0.1 * torch.randn(layer.bias.shape, generator=g))
    return net


def random_obs(n, seed):
    return torch.from_numpy((np.random.default_rng(seed).random((n, 117)) < 0.2).astype(np.int8))


def assert_close(got, want):
    gap = float((got - want).abs().max() / want.abs().max())
    assert gap <= 1e-5, gap


NETS = [(64, 2), (32, 1)]


@pytest.mark.parametrize("channels,blocks", NETS)
@pytest.mark.parametrize("batch", [1, 37])
def test_dense_form_matches_conv_form(channels, blocks, batch):
    net, obs = random_net(channels, blocks), random_obs(batch, batch)
    with torch.no_grad():
        got, want = net(obs), conv_form(net, obs)
    assert got[0].shape == (batch, 54) and got[1].shape == (batch,)
    for g, w in zip(got, want):
        assert_close(g, w)


def test_forward_is_the_same_when_recording():
    """With gradients recorded the ReLU is a pass of its own, without it is
    in the product's epilogue: the same numbers, bit for bit."""
    net, obs = random_net(32, 1), random_obs(37, 3)
    with torch.no_grad():
        bare = net(obs)
    recorded = net(obs)
    assert recorded[0].requires_grad
    for a, b in zip(recorded, bare):
        torch.testing.assert_close(a.detach(), b, rtol=0, atol=0)


@pytest.mark.parametrize("channels,blocks", NETS)
def test_gradients_match_conv_form(channels, blocks):
    """Every parameter's gradient, the convs' weights and biases through the
    dense weight's contraction and the tiled bias, equals the conv form's."""
    net, obs = random_net(channels, blocks), random_obs(37, 5)
    g = torch.Generator().manual_seed(7)
    cot_l, cot_v = torch.randn(37, 54, generator=g), torch.randn(37, generator=g)
    grads = []
    for forward in (net, lambda o: conv_form(net, o)):
        net.zero_grad(set_to_none=True)
        logits, value = forward(obs)
        ((logits * cot_l).sum() + (value * cot_v).sum()).backward()
        grads.append({name: p.grad.clone() for name, p in net.named_parameters()})
    dense, conv = grads
    assert set(dense) == {f"convs.{i}.{k}" for i in range(1 + 2 * blocks)
                          for k in ("weight", "bias")} | {"logits.weight", "logits.bias",
                                                         "value.weight", "value.bias"}
    for name in conv:
        assert conv[name].abs().max() > 0, name
        assert_close(dense[name], conv[name])


@pytest.mark.parametrize("cell", range(9))
def test_each_tap_lands_on_its_neighbour(cell):
    """A kernel whose nine taps all differ, read from the dense matrix's row
    of input ``cell`` in both row orders: output cell q gets tap
    (cell - q + (1, 1)) where ``cell`` is q's neighbour, and 0 elsewhere
    (the zero padding at the corners and edges)."""
    c_in, c_out, ci, co = 3, 2, 1, 1
    weight = torch.zeros(c_out, c_in, 3, 3)
    weight[co, ci] = torch.arange(1.0, 10.0).reshape(3, 3)
    ph, pw = divmod(cell, 3)
    want = torch.zeros(9, c_out)
    for q in range(9):
        kh, kw = ph - q // 3 + 1, pw - q % 3 + 1
        if 0 <= kh < 3 and 0 <= kw < 3:
            want[q, co] = weight[co, ci, kh, kw]
    assert int(want.count_nonzero()) == (3 if ph == 1 else 2) * (3 if pw == 1 else 2)
    for cells_first, row in ((True, cell * c_in + ci), (False, ci * 9 + cell)):
        dense = ac.dense_conv_weight(weight, ac.tap_selector(), cells_first, torch.float32)
        assert dense.shape == (9 * c_in, 9 * c_out)
        torch.testing.assert_close(dense[row].reshape(9, c_out), want, rtol=0, atol=0)
        # the 9 cells' neighbours, 4 at a corner, 6 on an edge, 9 at the centre
        assert int(dense.count_nonzero()) == 4 * 4 + 4 * 6 + 9


def test_tap_selector_is_the_padding():
    """Each output cell has one input cell a tap where that tap reaches the
    board: 4 neighbours at a corner, 6 on an edge, 9 at the centre, and the
    centre tap (4) is the cell itself."""
    taps = ac.tap_selector()
    assert taps.shape == (81, 9) and taps.dtype == torch.float32
    taps = taps.reshape(9, 9, 9)                                     # [p, q, t]
    assert set(taps.unique().tolist()) == {0.0, 1.0}
    assert taps.sum((0, 2)).tolist() == [4, 6, 4, 6, 9, 6, 4, 6, 4]
    assert int(taps.sum(2).max()) == 1 and int(taps.sum(0).max()) == 1
    torch.testing.assert_close(taps[:, :, 4], torch.eye(9), rtol=0, atol=0)


def test_taps_stay_out_of_the_state_dict():
    """The selector is a buffer that moves with the net and is not saved, so
    the state dict's keys are the parameters' alone."""
    net = random_net(8, 1)
    assert set(net.state_dict()) == {name for name, _ in net.named_parameters()}
    assert net.to(torch.float64).taps.dtype == torch.float64


def test_import_builds_nothing():
    """A fresh interpreter imports the zoo (and with it the net, the AZ
    trainer and the search) with no CUDA call and no tensor in the net's
    module; building and running a net on the CPU makes none either."""
    code = (
        "import torch\n"
        "calls = []\n"
        "torch.cuda._lazy_init = lambda *a, **k: calls.append('lazy_init')\n"
        "import gobblet_rl_torch.zoo\n"
        "from gobblet_rl_torch.models import actor_critic as ac\n"
        "assert not calls and not torch.cuda.is_initialized(), calls\n"
        "held = [k for k, v in vars(ac).items() if isinstance(v, torch.Tensor)\n"
        "        or isinstance(v, dict) and not k.startswith('__')]\n"
        "assert not held, held\n"
        "net = ac.ConvActorCritic(channels=8, blocks=2, device='cpu')\n"
        "net.reset_parameters(torch.Generator().manual_seed(0))\n"
        "logits, value = net(torch.zeros(2, 117, dtype=torch.int8))\n"
        "assert not calls and not torch.cuda.is_initialized(), calls\n"
        "print(tuple(logits.shape), tuple(value.shape))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "(2, 54) (2,)"
