"""Masked actor-critic nets: a shared torso with a policy head (54 logits)
and a value head.

Port of ``gobblet_rl_tpu/models/actor_critic.py``.  Parameters are
float32; the forward pass casts them and the input to ``dtype`` (bfloat16
by default, float32 for exact comparisons) and returns float32 ``(logits
[B, 54], value [B])``.  Layers are built without initialisation (no draw
from the global RNG); :meth:`reset_parameters` initialises them as flax
does, from an explicit generator, or a state dict is loaded
(:func:`gobblet_rl_torch.models.convert.actor_critic_params_from_flax`).

Illegal logits are filled with -1e9 (not -inf, unlike the Q-net's
``masked_q``): a row whose actions are all masked stays finite.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from gobblet_rl_torch.core.types import NUM_ACTIONS, OBS_CHANNELS
from gobblet_rl_torch.device import resolve_device
from gobblet_rl_torch.models.mlp import lecun_normal_
from gobblet_rl_torch.ops import batched_core as bc


class _ActorCritic(nn.Module):
    """What both nets share: flax's init and the bf16 head."""

    dtype: torch.dtype
    logits: nn.Linear
    value: nn.Linear

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """LeCun-normal kernels (fan-in = inputs x kernel cells) and zero
        biases, flax's ``Dense`` and ``Conv`` default."""
        for layer in self.modules():
            if isinstance(layer, (nn.Linear, nn.Conv2d)):
                lecun_normal_(layer.weight, layer.weight[0].numel(), generator)
                layer.bias.zero_()

    def _cast(self, layer: nn.Module) -> tuple[torch.Tensor, torch.Tensor]:
        return layer.weight.to(self.dtype), layer.bias.to(self.dtype)

    def _heads(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        logits = F.linear(x, *self._cast(self.logits))
        value = F.linear(x, *self._cast(self.value))
        return logits.to(torch.float32), value[..., 0].to(torch.float32)


class MLPActorCritic(_ActorCritic):
    """Shared MLP torso with policy and value heads (117 -> hidden -> 54 / 1)
    on ``device`` (``None``: the CUDA card, or raise)."""

    def __init__(self, num_actions: int = NUM_ACTIONS, hidden_sizes: Sequence[int] = (128, 128),
                 dtype: torch.dtype = torch.bfloat16, in_features: int = 117, device=None):
        super().__init__()
        self.dtype = dtype
        device = resolve_device(device)
        widths = [in_features, *hidden_sizes]
        self.hidden = nn.ModuleList(
            skip_init(nn.Linear, i, o, device=device) for i, o in zip(widths, widths[1:])
        )
        self.logits = skip_init(nn.Linear, widths[-1], num_actions, device=device)
        self.value = skip_init(nn.Linear, widths[-1], 1, device=device)

    def forward(self, obs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = obs.reshape(obs.shape[0], -1).to(self.dtype)
        for layer in self.hidden:
            x = F.relu(F.linear(x, *self._cast(layer)))
        return self._heads(x)


class ConvActorCritic(_ActorCritic):
    """AlphaZero-flavoured conv torso over the 13 observation planes on the
    3x3 board: a 3x3 conv, then ``blocks`` residual blocks of two 3x3 convs,
    all ``channels`` wide, then the heads on the flattened planes.

    The input is flat [B, 117] in (channel, cell) order, so
    ``reshape(B, 13, 3, 3)`` is already NCHW.  flax flattens the last
    activations in NHWC order ``(h, w, c)``, so they are permuted to NHWC
    before the heads, and a flax ``Dense`` kernel loads as it is."""

    def __init__(self, num_actions: int = NUM_ACTIONS, channels: int = 64, blocks: int = 2,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.dtype = dtype
        self.blocks = blocks
        device = resolve_device(device)
        ins = [OBS_CHANNELS] + [channels] * (2 * blocks)
        self.convs = nn.ModuleList(
            skip_init(nn.Conv2d, i, channels, 3, padding=1, device=device) for i in ins
        )
        self.logits = skip_init(nn.Linear, 9 * channels, num_actions, device=device)
        self.value = skip_init(nn.Linear, 9 * channels, 1, device=device)

    def _conv(self, i: int, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, *self._cast(self.convs[i]), padding=1)  # flax "SAME"

    def forward(self, obs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        b = obs.shape[0]
        x = F.relu(self._conv(0, obs.reshape(b, OBS_CHANNELS, 3, 3).to(self.dtype)))
        for k in range(self.blocks):
            h = F.relu(self._conv(1 + 2 * k, x))
            x = F.relu(x + self._conv(2 + 2 * k, h))
        return self._heads(x.permute(0, 2, 3, 1).reshape(b, -1))


def masked_logits(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask.to(torch.bool), logits, -1e9)


def sample_masked(generator: torch.Generator | None, logits: torch.Tensor, mask: torch.Tensor,
                  gumbel: torch.Tensor | None = None):
    """(int32 actions, their log-probabilities): one categorical draw per
    row over the legal actions (Gumbel argmax, the form of
    ``jax.random.categorical``).  ``gumbel`` is an optional float32 field
    of ``logits``' shape; without it the noise comes from ``generator``."""
    ml = masked_logits(logits, mask)
    if gumbel is None:
        gumbel = bc.gumbel_field(generator, ml.shape, ml.device)
    action = (ml + gumbel).argmax(dim=-1)
    logp = torch.log_softmax(ml, dim=-1)
    return action.to(torch.int32), logp.gather(-1, action[:, None])[:, 0]


def logp_entropy(logits: torch.Tensor, mask: torch.Tensor, actions: torch.Tensor):
    """(log-probability of ``actions``, entropy over the legal actions)."""
    ml = masked_logits(logits, mask)
    logp_all = torch.log_softmax(ml, dim=-1)
    p = torch.exp(logp_all)
    entropy = -torch.where(mask.to(torch.bool), p * logp_all, 0.0).sum(dim=-1)
    logp = logp_all.gather(-1, actions.long()[:, None])[:, 0]
    return logp, entropy
