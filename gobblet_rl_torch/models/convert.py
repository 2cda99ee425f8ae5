"""Carry parameters between flax trees and the port's modules.

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
(both frameworks cross-correlate).  The ``*_to_flax`` functions are the
exact inverses: the same names, the flax layouts, float32 numpy arrays
with every key sorted as flax's own trees are.
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


def _host(state_dict, key: str) -> np.ndarray:
    x = state_dict[key].detach().cpu().numpy()
    if x.dtype != np.float32:
        raise ValueError(f"{key} is {x.dtype}, not float32")
    return x


def _save(out: dict, key: str, state_dict, name: str, axes: tuple) -> None:
    # np.array copies: the tree never shares memory with the module
    out[key] = {"bias": np.array(_host(state_dict, f"{name}.bias"), order="C"),
                "kernel": np.array(_host(state_dict, f"{name}.weight").transpose(axes), order="C")}


def _count(state_dict, prefix: str) -> int:
    return len({k.split(".")[1] for k in state_dict if k.startswith(prefix + ".")})


def _flax_tree(layers: dict) -> dict:
    return {"params": {k: layers[k] for k in sorted(layers)}}


def qnet_params_to_flax(state_dict, dueling: bool = False) -> dict:
    """The flax tree ``{"params": {"Dense_i": {"bias", "kernel"}}}`` of a
    :class:`~gobblet_rl_torch.models.mlp.QNet` state dict; inverse of
    :func:`qnet_params_from_flax`."""
    names = [f"hidden.{i}" for i in range(_count(state_dict, "hidden"))] + ["head"]
    names += ["value"] if dueling else []
    out = {}
    for i, name in enumerate(names):
        _save(out, f"Dense_{i}", state_dict, name, (1, 0))
    return _flax_tree(out)


def actor_critic_params_to_flax(state_dict, model: str) -> dict:
    """The flax tree of a ``ConvActorCritic`` (``model="conv"``) or
    ``MLPActorCritic`` (``model="mlp"``) state dict; inverse of
    :func:`actor_critic_params_from_flax`."""
    if model not in ("conv", "mlp"):
        raise ValueError(f"unknown actor-critic model {model!r}; 'conv' or 'mlp'")
    out = {}
    for i in range(_count(state_dict, "convs")):
        _save(out, f"Conv_{i}", state_dict, f"convs.{i}", (2, 3, 1, 0))
    names = [f"hidden.{i}" for i in range(_count(state_dict, "hidden"))] + ["logits", "value"]
    for i, name in enumerate(names):
        _save(out, f"Dense_{i}", state_dict, name, (1, 0))
    return _flax_tree(out)
