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

    Each conv runs as one dense matrix product (:func:`dense_conv_weight`)
    with its bias in the product's epilogue, and its ReLU too where no
    gradient is recorded, except in the second conv of a block, which adds
    the residual first.  The
    stem reads the flat [B, 117] input in its (channel, cell) order; every
    later activation is [B, 9·channels] in (cell, channel) order, flax's
    NHWC flattening, so a flax ``Dense`` kernel of the heads loads as it
    is."""

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
        # a constant, so not in the state dict
        self.register_buffer("taps", tap_selector(device), persistent=False)

    def _dense(self) -> tuple[list[torch.Tensor], tuple[torch.Tensor, ...]]:
        """Each conv's dense weight (:func:`dense_conv_weight`) and its bias
        tiled over the cells in (cell, channel) order, in ``dtype``: the
        block convs, all one shape, in one product and one copy, and the
        biases in one copy."""
        stem, *rest = self.convs
        weights = [dense_conv_weight(stem.weight, self.taps, False, self.dtype)]
        if rest:
            stacked = torch.stack([conv.weight for conv in rest])
            weights += dense_conv_weight(stacked, self.taps, True, self.dtype).unbind()
        biases = torch.stack([conv.bias for conv in self.convs]).to(self.dtype).repeat(1, 9)
        return weights, biases.unbind()

    def forward(self, obs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        weights, biases = self._dense()
        x = _dense_relu(obs.reshape(obs.shape[0], -1).to(self.dtype), weights[0], biases[0])
        for k in range(self.blocks):
            h = _dense_relu(x, weights[1 + 2 * k], biases[1 + 2 * k])
            x = _dense_relu(h, weights[2 + 2 * k], biases[2 + 2 * k], residual=x)
        return self._heads(x)


def _dense_relu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                residual: torch.Tensor | None = None) -> torch.Tensor:
    """relu(x @ weight + bias [+ residual]): the bias in the product's
    epilogue (cuBLASLt's on the card), and the ReLU there too where no
    residual is added and no gradient is recorded (PyTorch has no derivative
    for that call); elsewhere the ReLU is a pass over the rounded sum, which
    gives the same numbers."""
    if residual is None and not torch.is_grad_enabled():
        return torch._addmm_activation(bias, x, weight)
    y = torch.addmm(bias, x, weight)
    return (y if residual is None else y.add_(residual)).relu_()


def tap_selector(device=None) -> torch.Tensor:
    """float32 [81, 9], row 9·p + q: 1 at tap t where input cell p is output
    cell q's neighbour through the 3x3 kernel's tap t = p - q + (1, 1)."""
    cell = torch.arange(9, device=device)
    dh = cell[:, None] // 3 - cell // 3 + 1                                 # [p, q]
    dw = cell[:, None] % 3 - cell % 3 + 1
    inside = (dh >= 0) & (dh < 3) & (dw >= 0) & (dw < 3)
    return (((3 * dh + dw)[..., None] == cell) & inside[..., None]).reshape(81, 9).float()


def dense_conv_weight(weight: torch.Tensor, taps: torch.Tensor, cells_first: bool,
                      dtype: torch.dtype) -> torch.Tensor:
    """A 3x3 "SAME" conv on the 3x3 board, ``weight`` [..., c_out, c_in, 3,
    3], as the ``dtype`` matrix [..., 9·c_in, 9·c_out] that right-multiplies
    a flat input.

    The entry at (input cell p, channel ci; output cell q, channel co) is
    ``weight[co, ci, p - q + (1, 1)]`` where p is a neighbour of q, else 0
    (the padding).  Columns are in (cell, channel) order, and rows too if
    ``cells_first``, else in the observation's (channel, cell) order.  One
    product of :func:`tap_selector`'s ``taps`` with the kernels' taps, exact
    (each entry is one tap or none), its backward one small product too;
    then one copy that orders and casts it."""
    *lead, c_out, c_in = weight.shape[:-2]
    dense = (taps @ weight.reshape(-1, 9).t()).view(9, 9, -1, c_out, c_in)  # [p, q, n, co, ci]
    dense = dense.permute(2, 0, 4, 1, 3) if cells_first else dense.permute(2, 4, 0, 1, 3)
    return dense.to(dtype, memory_format=torch.contiguous_format).reshape(*lead, 9 * c_in, 9 * c_out)


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
