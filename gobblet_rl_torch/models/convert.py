"""Load flax ``QNet`` parameters into the port's :class:`QNet`.

The flax tree, as numpy arrays, is ``{"params": {"Dense_i": {"kernel":
[in, out], "bias": [out]}}}`` with the layers numbered in creation order:
the hidden layers first, then the head.  With ``dueling=True`` the head is
two layers, the advantage stream (``Dense_n``) before the value stream
(``Dense_{n+1}``).
"""

from __future__ import annotations

import numpy as np
import torch


def qnet_params_from_flax(params, dueling: bool = False) -> dict[str, torch.Tensor]:
    """State dict for :class:`gobblet_rl_torch.models.mlp.QNet`; each
    kernel ``[in, out]`` becomes a ``Linear.weight`` ``[out, in]``."""
    tree = params["params"] if "params" in params else params
    dense = sorted(tree, key=lambda name: int(name.split("_")[1]))
    heads = ["head", "value"] if dueling else ["head"]
    n_hidden = len(dense) - len(heads)
    if n_hidden < 0:
        raise ValueError(f"{len(dense)} Dense layers cannot hold a {'dueling' if dueling else 'plain'} head")
    names = [f"hidden.{i}" for i in range(n_hidden)] + heads
    out = {}
    for name, key in zip(names, dense):
        kernel = np.asarray(tree[key]["kernel"], np.float32)
        out[f"{name}.weight"] = torch.from_numpy(np.array(kernel.T, np.float32))  # a copy
        out[f"{name}.bias"] = torch.from_numpy(np.array(tree[key]["bias"], np.float32))
    return out
