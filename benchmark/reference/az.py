"""AlphaZero's residual policy-value net and its learner, in plain torch.

The net of Silver et al. (Science 362:1140, 2018), at the widths of the
``alphazero_gumbel32`` configuration: the 13 observation planes of the 3x3
board, a 3x3 stem convolution to ``channels``, ``blocks`` residual blocks
of two 3x3 convolutions (``relu(x + conv(relu(conv(x))))``), every
convolution "SAME"-padded with a bias, then the activations flattened in
(row, column, channel) order into a linear policy head of 54 logits and a
linear value head.  Illegal logits are filled with -1e9 where a mask is
applied.

Parameters are a dict of float32 tensors named ``convs.<i>.weight``
``[out, in, 3, 3]`` / ``.bias``, ``logits.*`` and ``value.*`` (weights
``[out, in]``).  The reference computes in float32 with TF32 off
(:func:`benchmark.reference.qnet.exact_float32`).  ``quant``, if given,
computes the net at a lower precision as a card does: every operand of a
convolution or matmul (input, weight, bias) and every result (the
convolution's product, then the product plus its bias, the residual sum,
each head's output) is rounded through it; gradients pass straight
through.  Through bfloat16 that is the configuration's own precision, the
yardstick of the search and of ``grad_excess``; through float8 e4m3 it is
the control, one precision below.

The learner is the AlphaZero update of the configuration: cross-entropy
of the search's target against the legal log-softmax plus ``value_coef``
times ``(tanh v - z)^2``, both averaged over the valid rows; the gradient
clipped to a global norm (scaled by ``max_norm / norm`` unless the norm is
below ``max_norm``, no epsilon); then AdamW with the decay on every
parameter (Loshchilov and Hutter's decoupled decay: ``p -= lr * (adam +
wd * p)``).  :func:`backfill` gives the value targets: each ply takes the
outcome of its game from the mover's side, and a game still running at
the segment's end takes its last ply's root value.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

OBS_CHANNELS, NUM_ACTIONS = 13, 54


def shapes(channels: int, blocks: int) -> dict:
    """Leaf name -> shape, in the program's state dict's order."""
    out = {}
    ins = [OBS_CHANNELS] + [channels] * (2 * blocks)
    for i, c_in in enumerate(ins):
        out[f"convs.{i}.weight"], out[f"convs.{i}.bias"] = (channels, c_in, 3, 3), (channels,)
    for head, width in (("logits", NUM_ACTIONS), ("value", 1)):
        out[f"{head}.weight"], out[f"{head}.bias"] = (width, 9 * channels), (width,)
    return out


def _same(x):
    return x


def forward(params: dict, obs: torch.Tensor, quant=None):
    """``(logits float32[N, 54], value float32[N])`` of the float32
    features ``obs`` [N, 117] in (channel, cell) order."""
    r = quant or _same
    n = obs.shape[0]
    blocks = (sum(1 for k in params if k.startswith("convs.") and k.endswith(".weight")) - 1) // 2

    def conv(i, x):
        w, b = params[f"convs.{i}.weight"], params[f"convs.{i}.bias"]
        y = r(F.conv2d(r(x), r(w), padding=1))
        return r(y + r(b)[None, :, None, None])

    x = torch.relu(conv(0, obs.reshape(n, OBS_CHANNELS, 3, 3)))
    for k in range(blocks):
        h = torch.relu(conv(1 + 2 * k, x))
        x = torch.relu(r(x + conv(2 + 2 * k, h)))
    flat = x.permute(0, 2, 3, 1).reshape(n, -1)

    def linear(name):
        w, b = params[f"{name}.weight"], params[f"{name}.bias"]
        return r(r(flat) @ r(w).t() + r(b))

    return linear("logits"), linear("value")[:, 0]


def priors(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """float32[N, 54]: the softmax over the legal actions (-1e9 elsewhere)."""
    return torch.softmax(torch.where(mask, logits, -1e9), dim=-1)


def backfill(done, winner, player, bootstrap_signed=None):
    """``(z float32[L, n], valid bool[L, n])`` of a segment's columns:
    ``done`` bool[L, n], ``winner`` int8[L, n] (+1 player 0 won, -1 player
    1), ``player`` int32[L, n] the mover at each ply.  Each ply takes its
    game's outcome from its mover's side; plies of a game that does not
    end inside the segment are invalid, unless ``bootstrap_signed``
    float32[n] (the last ply's root value, +1 = player 0) stands in for
    the outcome."""
    L = done.shape[0]
    z = torch.zeros(done.shape, dtype=torch.float32, device=done.device)
    valid = torch.zeros(done.shape, dtype=torch.bool, device=done.device)
    if bootstrap_signed is None:
        outcome = torch.zeros(done.shape[1], dtype=torch.float32, device=done.device)
        known = torch.zeros(done.shape[1], dtype=torch.bool, device=done.device)
    else:
        outcome = bootstrap_signed.to(torch.float32)
        known = torch.ones(done.shape[1], dtype=torch.bool, device=done.device)
    for t in range(L - 1, -1, -1):
        outcome = torch.where(done[t], winner[t].to(torch.float32), outcome)
        known = known | done[t]
        z[t] = torch.where(player[t] == 0, outcome, -outcome)
        valid[t] = known
    return z, valid


def loss(params, batch: dict, value_coef: float, quant=None):
    """The mean AlphaZero loss of ``batch`` (``obs`` float32 features,
    ``mask``, ``pi``, ``z``, ``valid``) over its valid rows."""
    logits, value = forward(params, batch["obs"], quant)
    logp = torch.log_softmax(torch.where(batch["mask"], logits, -1e9), dim=-1)
    policy = -(batch["pi"] * torch.where(batch["mask"], logp, 0.0)).sum(-1)
    v = (torch.tanh(value) - batch["z"]) ** 2
    w = batch["valid"].to(torch.float32)
    denom = w.sum().clamp(min=1.0)
    return (policy * w).sum() / denom + value_coef * (v * w).sum() / denom


def train(params0: dict, batches: list, cfg: dict, quant=None, rows: slice | None = None):
    """Clip and AdamW over ``batches`` (a list, one entry an iteration, of
    lists of minibatch dicts).  ``cfg`` holds ``lr``, ``betas``, ``eps``,
    ``weight_decay``, ``max_grad_norm`` and ``value_coef``.  Returns
    ``(losses, grad0, params)``: each iteration's mean loss, the first
    step's clipped gradient by leaf and the parameters at the end.
    ``rows`` keeps only those rows of every minibatch (a fault: part of
    the batch left out)."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in params0.items()}
    names = list(params)
    m = {k: torch.zeros_like(v) for k, v in params0.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params0.items()}
    lr, (b1, b2), eps, wd = cfg["lr"], cfg["betas"], cfg["eps"], cfg["weight_decay"]
    step, losses, grad0 = 0, [], None
    for minibatches in batches:
        it_losses = []
        for mb in minibatches:
            if rows is not None:
                mb = {k: x[rows] for k, x in mb.items()}
            value = loss(params, mb, cfg["value_coef"], quant)
            grads = torch.autograd.grad(value, [params[k] for k in names])
            step += 1
            with torch.no_grad():
                norm = torch.sqrt(sum((g * g).sum() for g in grads))
                if norm >= cfg["max_grad_norm"]:
                    grads = [g / norm * cfg["max_grad_norm"] for g in grads]
                if grad0 is None:
                    grad0 = {k: g.clone() for k, g in zip(names, grads)}
                for k, g in zip(names, grads):
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    adam = (m[k] / (1 - b1 ** step)) / ((v2[k] / (1 - b2 ** step)).sqrt() + eps)
                    params[k] -= lr * (adam + wd * params[k])
            it_losses.append(value.detach())
        losses.append(torch.stack(it_losses).mean().item())
    return losses, grad0, {k: p.detach() for k, p in params.items()}


def first_gradient(params0: dict, minibatch: dict, cfg: dict, quant=None) -> dict:
    """The clipped gradient by leaf of the first update of :func:`train`."""
    return train(params0, [[minibatch]], cfg, quant)[1]
