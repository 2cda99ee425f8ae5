"""Load flax parameters into the port's modules.

The flax trees, as numpy arrays, are ``{"params": {name: {"kernel", "bias"}}}``
with the layers numbered in creation order per kind:

* ``QNet``: ``Dense_i`` — the hidden layers, then the head; with
  ``dueling=True`` the head is two layers, the advantage stream
  (``Dense_n``) before the value stream (``Dense_{n+1}``).
* ``MLPActorCritic``: ``Dense_i`` — the hidden layers, then the logits and
  the value layer.
* ``ConvActorCritic``: ``Conv_0`` .. ``Conv_{2·blocks}`` with HWIO kernels
  ``[3, 3, in, out]``, then ``Dense_0`` (logits) and ``Dense_1`` (value).

A ``Dense`` kernel ``[in, out]`` becomes a ``Linear.weight`` ``[out, in]``;
a ``Conv`` kernel ``[h, w, in, out]`` a ``Conv2d.weight`` ``[out, in, h, w]``
(both frameworks cross-correlate).
"""

from __future__ import annotations

import numpy as np
import torch


def _layers(tree, kind: str) -> list:
    return sorted((k for k in tree if k.startswith(kind + "_")), key=lambda k: int(k.split("_")[1]))


def _load(out: dict, name: str, layer: dict, axes: tuple) -> None:
    kernel = np.asarray(layer["kernel"]).transpose(axes)
    out[f"{name}.weight"] = torch.from_numpy(np.array(kernel, np.float32, order="C"))  # a copy
    out[f"{name}.bias"] = torch.from_numpy(np.array(layer["bias"], np.float32))


def qnet_params_from_flax(params, dueling: bool = False) -> dict[str, torch.Tensor]:
    """State dict for :class:`gobblet_rl_torch.models.mlp.QNet`."""
    tree = params["params"] if "params" in params else params
    dense = _layers(tree, "Dense")
    heads = ["head", "value"] if dueling else ["head"]
    n_hidden = len(dense) - len(heads)
    if n_hidden < 0:
        raise ValueError(f"{len(dense)} Dense layers cannot hold a {'dueling' if dueling else 'plain'} head")
    out = {}
    for name, key in zip([f"hidden.{i}" for i in range(n_hidden)] + heads, dense):
        _load(out, name, tree[key], (1, 0))
    return out


def actor_critic_params_from_flax(params, model: str) -> dict[str, torch.Tensor]:
    """State dict for :class:`~gobblet_rl_torch.models.actor_critic.ConvActorCritic`
    (``model="conv"``) or ``MLPActorCritic`` (``model="mlp"``)."""
    tree = params["params"] if "params" in params else params
    dense, convs = _layers(tree, "Dense"), _layers(tree, "Conv")
    if model == "conv":
        if len(dense) != 2 or len(convs) % 2 != 1:
            raise ValueError(f"a conv actor-critic has 2 Dense and 2·blocks + 1 Conv layers, "
                             f"not {len(dense)} and {len(convs)}")
        names = ["logits", "value"]
    elif model == "mlp":
        if len(dense) < 2 or convs:
            raise ValueError(f"an MLP actor-critic has at least 2 Dense and no Conv layers, "
                             f"not {len(dense)} and {len(convs)}")
        names = [f"hidden.{i}" for i in range(len(dense) - 2)] + ["logits", "value"]
    else:
        raise ValueError(f"unknown actor-critic model {model!r}; 'conv' or 'mlp'")
    out = {}
    for i, key in enumerate(convs):
        _load(out, f"convs.{i}", tree[key], (3, 2, 0, 1))
    for name, key in zip(names, dense):
        _load(out, name, tree[key], (1, 0))
    return out
