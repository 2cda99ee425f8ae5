"""The DQN recipe's Q-network and its double-DQN update, in plain torch.

An MLP ``117 -> hidden... -> 54`` with ReLU, and with a dueling head
``Q = V + A - mean(A)`` where the configuration asks for one.  Parameters
are a dict of float32 tensors named ``hidden.<i>.weight`` / ``.bias``,
``head.*`` and ``value.*``, weights ``[out, in]``.

The reference computes in float32 with TF32 off.  ``quant``, if given,
rounds every matmul operand (the layer's input and its weight) through a
lower precision on the way forward and passes gradients straight through:
through float8 that is the control, the same computation one precision
below the configuration's bfloat16; through bfloat16 it is the yardstick
that the program's first gradient is measured in.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matmuls and convolutions, restored on exit."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded through float8 e4m3 (saturating at its largest
    value), gradient passed straight through."""
    q = x.clamp(-448.0, 448.0).to(torch.float8_e4m3fn).to(torch.float32)
    return x + (q - x).detach()


def bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded through bfloat16, gradient passed straight through:
    the configuration's own compute precision, the yardstick of
    ``grad_excess``."""
    return x + (x.to(torch.bfloat16).to(torch.float32) - x).detach()


def first_gradient(params0: dict, minibatch: dict, cfg: dict, quant=None) -> dict:
    """The gradient by leaf of the first update of :func:`train`."""
    return train(params0, [[minibatch]], cfg, quant)[1]


def leaf_names(hidden: int, dueling: bool) -> list:
    names = []
    for layer in [f"hidden.{i}" for i in range(hidden)] + ["head"] + (["value"] if dueling else []):
        names += [f"{layer}.weight", f"{layer}.bias"]
    return names


def _linear(x, params, name, quant):
    w = params[f"{name}.weight"]
    if quant is not None:
        x, w = quant(x), quant(w)
    return x @ w.t() + params[f"{name}.bias"]


def forward(params: dict, x: torch.Tensor, quant=None) -> torch.Tensor:
    """float32[N, 54] Q-values of the float32 features ``x`` [N, 117]."""
    i = 0
    while f"hidden.{i}.weight" in params:
        x = torch.relu(_linear(x, params, f"hidden.{i}", quant))
        i += 1
    adv = _linear(x, params, "head", quant)
    if "value.weight" not in params:
        return adv
    return _linear(x, params, "value", quant) + adv - adv.mean(-1, keepdim=True)


def td_loss(params, target, batch, gamma_n: float, double: bool, quant=None):
    """The mean squared TD error of ``batch`` (features ``obs``, ``obs_n``,
    ``action``, ``reward_n``, ``done_n``, ``mask_n``)."""
    with torch.no_grad():
        q_next = forward(target, batch["obs_n"], quant).masked_fill(~batch["mask_n"], -torch.inf)
        if double:
            online = forward(params, batch["obs_n"], quant).masked_fill(~batch["mask_n"],
                                                                        -torch.inf)
            q_star = q_next.gather(1, online.argmax(1, keepdim=True))[:, 0]
        else:
            q_star = q_next.max(1).values
        live = (~batch["done_n"]).to(torch.float32)
        y = batch["reward_n"] + gamma_n * live * torch.where(live > 0, q_star, 0.0)
    q = forward(params, batch["obs"], quant)
    q_a = q.gather(1, batch["action"].long()[:, None])[:, 0]
    return ((q_a - y) ** 2).mean()


def train(params0: dict, batches: list, cfg: dict, quant=None, rows: slice | None = None):
    """Double-DQN with Adam over ``batches``: a list, one entry an
    iteration, of lists of minibatch dicts.  Returns ``(losses, grad0,
    params)``: each iteration's mean loss, the first step's gradient by
    leaf and the parameters at the end.  ``rows`` keeps only those rows of
    every minibatch (a fault: part of the batch left out)."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in params0.items()}
    target = {k: v.detach().clone() for k, v in params0.items()}
    m = {k: torch.zeros_like(v) for k, v in params0.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params0.items()}
    lr, (b1, b2), eps = cfg["lr"], cfg["betas"], cfg["eps"]
    gamma_n = cfg["gamma"] ** cfg["n_step"]
    step, losses, grad0 = 0, [], None
    names = list(params)
    for minibatches in batches:
        it_losses = []
        for mb in minibatches:
            if rows is not None:
                mb = {k: x[rows] for k, x in mb.items()}
            loss = td_loss(params, target, mb, gamma_n, cfg["double"], quant)
            grads = torch.autograd.grad(loss, [params[k] for k in names])
            step += 1
            with torch.no_grad():
                if grad0 is None:
                    grad0 = {k: g.clone() for k, g in zip(names, grads)}
                for k, g in zip(names, grads):
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (v2[k] / (1 - b2 ** step)).sqrt() + eps
                    params[k] -= lr * (m[k] / (1 - b1 ** step)) / denom
                if step % cfg["target_update_freq"] == 0:
                    target = {k: p.detach().clone() for k, p in params.items()}
            it_losses.append(loss.detach())
        losses.append(torch.stack(it_losses).mean().item())
    return losses, grad0, {k: p.detach() for k, p in params.items()}
