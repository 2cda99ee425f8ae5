"""Tensor (model) parallelism over the mesh's MODEL_AXIS, with explicit
collectives.

Port of ``gobblet_rl_tpu/parallel/tensor_parallel.py``.  JAX annotates the
parameter tree and lets GSPMD plant the collectives; here each rank of a
model group holds its block of every sharded parameter and the forward
pass says where the data crosses ranks:

* Linear layers alternate column-parallel (output features split: a local
  matmul, the activations stay feature-sharded) and row-parallel (input
  features split: a local matmul plus a summing all-reduce); a layer whose
  shardable dim does not divide (the 54-way head) stays replicated;
* a conv layer shards its output channels: a local conv plus an
  all-gather over the channels.

Each collective is a ``torch.autograd.Function`` whose backward is its
adjoint under a loss every rank computes alike: all-reduce <-> identity
(a copy into a sharded layer all-reduces its gradient), all-gather <->
taking the rank's slice.  ``torch.distributed.tensor`` is not used: its
conv rule does not cover output-channel sharding.

The layout is torch's: ``Linear.weight`` is ``[out, in]``, so a
column-parallel weight is split on dim 0 and a row-parallel one on dim 1,
and a ``Conv2d.weight`` (OIHW) on dim 0 (JAX's ``[in, out]`` and HWIO
kernels split the mirrored dims).
"""

from __future__ import annotations

import copy

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from gobblet_rl_torch.core.types import OBS_CHANNELS
from gobblet_rl_torch.models.actor_critic import ConvActorCritic, MLPActorCritic
from gobblet_rl_torch.models.mlp import QNet
from gobblet_rl_torch.parallel.mesh import (ENV_AXIS, MODEL_AXIS, GradSync, axis_index,
                                            axis_size, local_block)

COL, ROW = (MODEL_AXIS, None), (None, MODEL_AXIS)
CONV_OUT = (MODEL_AXIS, None, None, None)


def tp_specs(net: nn.Module, model_size: int) -> dict[str, tuple]:
    """Spec of every parameter of ``net``, by ``state_dict`` name.

    Linear weights alternate column-/row-parallel in traversal order (the
    order of the flax tree's layers); a weight whose shardable dim does not
    divide by ``model_size`` stays replicated.  Biases follow their weight:
    sharded after a column-parallel layer, replicated after a row-parallel
    one.  Conv weights shard their output channels."""
    specs = {}
    col_next = True   # alternation state across Linear layers
    for name, layer in net.named_modules():
        if isinstance(layer, nn.Linear):
            d_out, d_in = layer.weight.shape
            if col_next and d_out % model_size == 0:
                w, b, col_next = COL, (MODEL_AXIS,), False
            elif not col_next and d_in % model_size == 0:
                w, b, col_next = ROW, (), True
            else:
                w, b = (), ()
        elif isinstance(layer, nn.Conv2d):
            sharded = layer.weight.shape[0] % model_size == 0
            w, b = (CONV_OUT, (MODEL_AXIS,)) if sharded else ((), ())
        else:
            continue
        specs[f"{name}.weight"], specs[f"{name}.bias"] = w, b
    return specs


class _AllReduceSum(torch.autograd.Function):
    """Sum over the model group; backward: identity."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyToModel(torch.autograd.Function):
    """Identity into a sharded layer; backward: sum over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


def _gather(x, dim, group, size):
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


class _Gather(torch.autograd.Function):
    """All-gather the blocks of ``dim``; backward: this rank's slice."""

    @staticmethod
    def forward(ctx, x, dim, group, rank, size):
        ctx.dim, ctx.rank, ctx.k = dim, rank, x.shape[dim]
        return _gather(x, dim, group, size)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.rank * ctx.k, ctx.k).contiguous(), None, None, None, None


class _Split(torch.autograd.Function):
    """This rank's block of ``dim``; backward: all-gather the blocks."""

    @staticmethod
    def forward(ctx, x, dim, group, rank, size):
        ctx.dim, ctx.group, ctx.size = dim, group, size
        k = x.shape[dim] // size
        return x.narrow(dim, rank * k, k).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, ctx.dim, ctx.group, ctx.size), None, None, None, None


class TPNet(nn.Module):
    """``QNet``, ``MLPActorCritic`` or ``ConvActorCritic`` split over the
    mesh's model axis: a copy of ``net`` whose parameters are this rank's
    blocks under :func:`tp_specs`, with the same forward signature and
    outputs (every rank of a model group returns the whole output)."""

    def __init__(self, net: nn.Module, mesh):
        super().__init__()
        if not isinstance(net, (QNet, MLPActorCritic, ConvActorCritic)):
            raise TypeError(f"no tensor-parallel forward for {type(net).__name__}")
        self.group = mesh.get_group(MODEL_AXIS)
        self.size, self.rank = axis_size(mesh, MODEL_AXIS), axis_index(mesh, MODEL_AXIS)
        self.specs = tp_specs(net, self.size)
        self.net = copy.deepcopy(net)
        for name, p in list(self.net.named_parameters()):
            owner, attr = name.rsplit(".", 1)
            setattr(self.net.get_submodule(owner), attr,
                    nn.Parameter(local_block(p.detach(), self.specs[name], mesh)))

    # -- collectives ---------------------------------------------------------
    def _gather(self, x, dim):
        return _Gather.apply(x, dim, self.group, self.rank, self.size)

    def _full(self, act):
        x, sharded = act
        return self._gather(x, -1) if sharded else x

    # -- layers --------------------------------------------------------------
    def _linear(self, name: str, act):
        """(output, feature-sharded?) of Linear ``name`` on ``act`` =
        (input, feature-sharded?)."""
        layer, spec = self.net.get_submodule(name), self.specs[f"{name}.weight"]
        w, b = layer.weight.to(self.net.dtype), layer.bias.to(self.net.dtype)
        if spec == COL:
            x = _CopyToModel.apply(self._full(act), self.group)
            return F.linear(x, w, b), True
        if spec == ROW:
            x, sharded = act
            if not sharded:
                x = _Split.apply(x, -1, self.group, self.rank, self.size)
            return _AllReduceSum.apply(F.linear(x, w), self.group) + b, False
        return F.linear(self._full(act), w, b), False

    def _conv(self, i: int, x):
        layer = self.net.convs[i]
        w, b = layer.weight.to(self.net.dtype), layer.bias.to(self.net.dtype)
        if self.specs[f"convs.{i}.weight"] == CONV_OUT:
            y = F.conv2d(_CopyToModel.apply(x, self.group), w, b, padding=1)
            return self._gather(y, 1)
        return F.conv2d(x, w, b, padding=1)

    def forward(self, obs: torch.Tensor):
        net, b = self.net, obs.shape[0]
        if isinstance(net, ConvActorCritic):
            x = F.relu(self._conv(0, obs.reshape(b, OBS_CHANNELS, 3, 3).to(net.dtype)))
            for k in range(net.blocks):
                h = F.relu(self._conv(1 + 2 * k, x))
                x = F.relu(x + self._conv(2 + 2 * k, h))
            act = (x.permute(0, 2, 3, 1).reshape(b, -1), False)
        else:
            act = (obs.reshape(b, -1).to(net.dtype), False)
            for i in range(len(net.hidden)):
                x, sharded = self._linear(f"hidden.{i}", act)
                act = (F.relu(x), sharded)
        if isinstance(net, QNet):
            adv = self._full(self._linear("head", act))
            if not net.dueling:
                return adv.to(torch.float32)
            val = self._full(self._linear("value", act))
            return (val + adv - adv.mean(dim=-1, keepdim=True)).to(torch.float32)
        logits = self._full(self._linear("logits", act))
        value = self._full(self._linear("value", act))
        return logits.to(torch.float32), value[..., 0].to(torch.float32)

    # -- whole parameters ----------------------------------------------------
    def grad_sq_norm(self, grads) -> torch.Tensor:
        """Squared global norm of the gradients of the WHOLE parameters, from
        this rank's ``grads`` (in ``parameters()`` order): the sharded
        blocks' sum over the model group plus the replicated ones'."""
        sharded = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        rep = torch.zeros_like(sharded)
        for (name, _), g in zip(self.net.named_parameters(), grads):
            if self.specs[name]:
                sharded = sharded + (g * g).sum()
            else:
                rep = rep + (g * g).sum()
        dist.all_reduce(sharded, op=dist.ReduceOp.SUM, group=self.group)
        return sharded + rep

    @torch.no_grad()
    def full_state_dict(self) -> dict[str, torch.Tensor]:
        """The whole parameters (an all-gather of each sharded one), by the
        original net's ``state_dict`` names."""
        out = {}
        for name, p in self.net.named_parameters():
            spec = self.specs[name]
            out[name] = (_gather(p.detach(), spec.index(MODEL_AXIS), self.group, self.size)
                         if spec else p.detach().clone())
        return out


def shard_params_tp(net: nn.Module, mesh) -> TPNet:
    """``net`` split tensor-parallel over mesh[MODEL_AXIS]."""
    return TPNet(net, mesh)


def shard_batch_dp(batch, mesh):
    """This rank's block of the leading batch axis over ENV_AXIS, for a
    tensor or a tuple, list or dict of them (batch-first arrays)."""
    def block(x):
        return local_block(x, (ENV_AXIS,), mesh)

    if isinstance(batch, dict):
        return {k: block(v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(block(x) for x in batch)
    return block(batch)


def place_dp_tp(st, mesh):
    """An ``AZState`` placed for a DP x TP run: its net split over the
    model axis (:class:`TPNet`), a fresh optimizer of the same kind and
    hyperparameters over the blocks (so its state is tensor-parallel too)
    and this rank's block of the env batch over the env axis.  Run the
    update phase with ``grad_sync=GradSync(mesh.get_group(ENV_AXIS))`` and
    ``grad_sq_norm=net.grad_sq_norm``."""
    from gobblet_rl_torch.parallel.mesh import shard_env_state
    from gobblet_rl_torch.train.alphazero import AZState

    tp_net = shard_params_tp(st.net, mesh)
    optimizer = type(st.optimizer)(tp_net.parameters())
    optimizer.param_groups[0].update(
        {k: v for k, v in st.optimizer.param_groups[0].items() if k != "params"})
    return AZState(net=tp_net, optimizer=optimizer,
                   env_state=shard_env_state(st.env_state, mesh))


def make_tp_train_step(net: TPNet, optimizer, mesh):
    """DP x TP supervised Q-regression step on this rank's block of the
    batch (``shard_batch_dp``): ``step(obs, mask, target) -> loss``, the
    loss averaged over the env group; the gradients of the blocks average
    over the env group (the ranks holding the same blocks) before the
    optimizer steps, in place."""
    sync = GradSync(mesh.get_group(ENV_AXIS))

    def step(obs, mask, target):
        q = torch.where(mask, net(obs), 0.0)
        loss = ((q - target) ** 2).mean()
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        (loss,) = sync(net.parameters(), loss)
        optimizer.step()
        return loss

    return step
