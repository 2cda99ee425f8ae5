"""Q-network of the DQN recipe: an MLP 117 -> [128]*4 -> 54.

Port of ``gobblet_rl_tpu/models/mlp.py``.  Parameters are float32; the
forward pass casts them and the input to ``dtype`` (bfloat16 by default,
float32 for exact comparisons) and returns float32 Q-values.
``dueling=True`` splits the head into value and advantage streams:
``Q = V + A - mean(A)``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from gobblet_rl_torch.device import resolve_device


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's default kernel init, in place: a normal truncated at two
    standard deviations, variance 1/fan_in, drawn from ``generator``."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, (1 + math.erf(2 / math.sqrt(2))) / 2
    weight.uniform_(2 * lo - 1, 2 * hi - 1, generator=generator)
    weight.erfinv_().mul_(std * math.sqrt(2.0))


class QNet(nn.Module):
    """MLP Q-net on ``device`` (``None``: the CUDA card, or raise).  Layers
    are built without initialisation (no draw from the global RNG);
    :meth:`reset_parameters` initialises them from an explicit generator, or
    a state dict is loaded."""

    def __init__(self, num_actions: int = 54,
                 hidden_sizes: Sequence[int] = (128, 128, 128, 128),
                 dtype: torch.dtype = torch.bfloat16, dueling: bool = False,
                 in_features: int = 117, device=None):
        super().__init__()
        self.dtype = dtype
        self.dueling = dueling
        device = resolve_device(device)
        widths = [in_features, *hidden_sizes]
        self.hidden = nn.ModuleList(
            skip_init(nn.Linear, i, o, device=device) for i, o in zip(widths, widths[1:])
        )
        self.head = skip_init(nn.Linear, widths[-1], num_actions, device=device)
        self.value = skip_init(nn.Linear, widths[-1], 1, device=device) if dueling else None

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's ``Dense`` default: LeCun-normal weights (a normal truncated
        at two standard deviations, variance 1/fan_in) and zero biases."""
        for layer in self.modules():
            if isinstance(layer, nn.Linear):
                lecun_normal_(layer.weight, layer.in_features, generator)
                layer.bias.zero_()

    def _linear(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, layer.weight.to(self.dtype), layer.bias.to(self.dtype))

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        x = obs.reshape(obs.shape[0], -1).to(self.dtype)
        for layer in self.hidden:
            x = F.relu(self._linear(layer, x))
        if self.dueling:
            adv = self._linear(self.head, x)
            val = self._linear(self.value, x)
            q = val + adv - adv.mean(dim=-1, keepdim=True)
        else:
            q = self._linear(self.head, x)
        return q.to(torch.float32)


def masked_q(q_values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Q-values with illegal actions driven to -inf."""
    return torch.where(mask.to(torch.bool), q_values, -torch.inf)


def masked_argmax(q_values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """int32 argmax over the legal actions; ties go to the first index."""
    return masked_q(q_values, mask).argmax(dim=-1).to(torch.int32)
