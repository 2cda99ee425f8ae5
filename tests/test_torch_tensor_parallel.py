"""Port parity for ``gobblet_rl_torch/parallel/tensor_parallel.py`` (the
twin of tests/test_sharding.py:114-250).

* The plan equals JAX's ``tp_specs`` layer for layer, through
  ``models/convert.py``'s names (torch's ``[out, in]`` and OIHW layouts
  mirror flax's ``[in, out]`` and HWIO), for ``QNet`` (dueling and plain)
  and ``ConvActorCritic`` at model sizes 2, 4 and 8.
* On four gloo ranks (``tests/torch_ranks.py``, no JAX), float32 nets:
  the TP forward of ``QNet`` on meshes 2x2 and 1x4 equals the replicated
  net's on the rank's block of the batch; one DP x TP Q-regression step
  equals the replicated step on the whole batch; and the DP x TP update
  phase of the AlphaZero conv net (2 updates, clipped) equals the
  data-parallel update with replicated params on the same blocks, both
  nets computing in float64 over float32 params (in float32, AdamW at lr
  1e-2 turns the model axis's summation order into 3.5e-5 on a weight
  whose gradient is near zero).  All within 1e-5 (the row-parallel sums
  add in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gobblet_rl_torch.models import actor_critic as tac
from gobblet_rl_torch.models import mlp as tmlp
from gobblet_rl_torch.models.convert import _layers
from gobblet_rl_torch.parallel import tensor_parallel as ttp
from gobblet_rl_torch.parallel.multihost import spawn_ranks
from gobblet_rl_tpu.models import actor_critic as jac
from gobblet_rl_tpu.models.mlp import QNet as JQNet
from gobblet_rl_tpu.parallel import tensor_parallel as jtp
from tests import torch_ranks
from tests.test_torch_alphazero import flat_batch

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


def nets(kind):
    """(flax params, torch net, flax layer -> torch module name)."""
    obs = jnp.zeros((1, 117), jnp.int8)
    if kind == "conv":
        params = jac.ConvActorCritic(channels=64, blocks=2).init(jax.random.PRNGKey(0), obs)
        tree = params["params"]
        names = {k: f"convs.{i}" for i, k in enumerate(_layers(tree, "Conv"))}
        names.update(zip(_layers(tree, "Dense"), ["logits", "value"]))
        return params, tac.ConvActorCritic(channels=64, blocks=2, device=CPU), names
    dueling = kind == "dueling"
    params = JQNet(dueling=dueling).init(jax.random.PRNGKey(0), obs)
    dense = _layers(params["params"], "Dense")
    heads = ["head", "value"] if dueling else ["head"]
    names = dict(zip(dense, [f"hidden.{i}" for i in range(len(dense) - len(heads))] + heads))
    return params, tmlp.QNet(dueling=dueling, device=CPU), names


def torch_layout(spec: tuple, ndim: int) -> tuple:
    """A flax kernel's spec in torch's layout: [in, out] -> [out, in], HWIO
    -> OIHW; biases and replicated leaves as they are."""
    spec = tuple(spec) + (None,) * (ndim - len(spec)) if spec else ()
    if not spec or ndim == 1:
        return spec
    return spec[::-1] if ndim == 2 else (spec[3], spec[2], spec[0], spec[1])


@pytest.mark.parametrize("model_size", [2, 4, 8])
@pytest.mark.parametrize("kind", ["dueling", "plain", "conv"])
def test_plan_equals_jax_tp_specs(kind, model_size):
    params, net, names = nets(kind)
    jspecs = jtp.tp_specs(params, model_size)["params"]
    got = ttp.tp_specs(net, model_size)
    assert set(got) == set(net.state_dict())
    for layer, module in names.items():
        for leaf, attr in (("kernel", "weight"), ("bias", "bias")):
            ndim = params["params"][layer][leaf].ndim
            assert got[f"{module}.{attr}"] == torch_layout(jspecs[layer][leaf], ndim), (
                layer, leaf)
    if kind != "conv":   # the 54-way head shards only where 54 divides
        assert (got["head.weight"] == ttp.COL) == (model_size == 2)


@pytest.fixture(scope="module")
def tp_results():
    rng = np.random.default_rng(0)
    obs = (rng.random((64, 117)) < 0.2).astype(np.int8)
    mask = rng.random((64, 54)) < 0.7
    target = rng.normal(size=(64, 54)).astype(np.float32)
    flats = [flat_batch(100, 10 + r) for r in range(2)]
    perm = rng.permutation(100).astype(np.int64)
    return spawn_ranks(torch_ranks.tp_rank, 4, (obs, mask, target, flats, perm), device="cpu",
                       timeout=180)


def test_tp_forward_matches_replicated(tp_results):
    for res in tp_results:
        for key in ("forward_mp2_dueling", "forward_mp2_plain", "forward_mp4_dueling",
                    "forward_mp4_plain"):
            assert res[key] < 1e-5, key
        mp2, mp4 = res["shapes_mp2_dueling"], res["shapes_mp4_dueling"]
        # alternating column/row blocks; the head splits over 2 but not 4
        assert mp2["hidden.0.weight"] == (64, 117) and mp2["hidden.1.weight"] == (128, 64)
        assert mp2["head.weight"] == (27, 128) and mp2["value.weight"] == (1, 64)
        assert mp4["hidden.0.weight"] == (32, 117) and mp4["hidden.3.weight"] == (128, 32)
        assert mp4["head.weight"] == (54, 128) and mp4["value.weight"] == (1, 128)


def test_tp_train_step_matches_replicated(tp_results):
    for res in tp_results:
        step = res["step"]
        np.testing.assert_allclose(*step["loss"], atol=1e-5, rtol=0)
        assert step["params"] < 1e-5 and step["moved"] > 0
        assert step["col_rows"] == (32, 117)   # the update keeps the blocks


def test_az_conv_dp_tp_update_matches_replicated(tp_results):
    for res in tp_results:
        az = res["az"]
        assert az["loss"] < 1e-5 and az["params"] < 1e-5
        assert az["conv0"] == (8, 13, 3, 3)   # output channels split over the model axis
        assert az["env"] == (3, 9, 8)         # the env batch over the env axis
