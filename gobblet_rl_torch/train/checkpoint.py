"""Checkpoints of the DQN, AlphaZero and PPO training states, and exact
resume points.

Port of ``gobblet_rl_tpu/train/checkpoint.py`` with its own on-disk format:
each step is one ``ckpt-<step>.pt`` file written by ``torch.save`` from
plain dicts of tensors, ints, floats, tuples and ``None`` (no pickled
classes), and read back with ``torch.load(..., weights_only=True)``.  Every
file is written to a temporary name and then ``os.replace``-d into place, so
a crash leaves either the old file or the new one.  A directory keeps the
newest 3 steps.

A full resume point (:func:`save_full`) holds everything a run needs to
continue bit for bit: the learner, target and opponent nets, the Adam state
and ``grad_steps``, the env batch, the replay ring with its cursor, and the
torch generator's state.  Host-side state that is not a tensor (the numpy
generator of the mixed opponent) goes into the JSON sidecar
``meta-<step>.json``, written before the payload.  An AlphaZero resume
point (:func:`save_az` with a generator) holds the net, the AdamW state,
the env batch and the generator's state.  A PPO resume point
(:func:`save_ppo`) holds both nets, both Adam states, both env batches,
the generator's state and the league pool (a list of state dicts); the
opponent draw's numpy generator goes into the sidecar.
"""

from __future__ import annotations

import json
import os
import re

import torch

from gobblet_rl_torch.ops.batched_core import PlanesState

MAX_TO_KEEP = 3
_CKPT = re.compile(r"^ckpt-(\d+)\.pt$")


def _path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"ckpt-{step}.pt")


def _meta_path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"meta-{step}.json")


def _steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for f in os.listdir(directory) if (m := _CKPT.match(f)))


def _atomic_save(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def train_state_dict(train_state) -> dict:
    """Plain dict of a :class:`~gobblet_rl_torch.train.dqn.TrainState`."""
    return {
        "net": train_state.net.state_dict(),
        "target_net": train_state.target_net.state_dict(),
        "opponent_net": train_state.opponent_net.state_dict(),
        "optimizer": train_state.optimizer.state_dict(),
        "grad_steps": int(train_state.grad_steps),
    }


def load_train_state(train_state, state: dict):
    """Load :func:`train_state_dict`'s dict into ``train_state`` in place."""
    train_state.net.load_state_dict(state["net"])
    train_state.target_net.load_state_dict(state["target_net"])
    train_state.opponent_net.load_state_dict(state["opponent_net"])
    train_state.optimizer.load_state_dict(state["optimizer"])
    train_state.grad_steps = int(state["grad_steps"])
    return train_state


def save_payload(directory: str, payload: dict, step: int, meta: dict | None = None) -> None:
    """Write ``payload`` (a plain dict) as step ``step``, then drop all but
    the newest :data:`MAX_TO_KEEP` steps.

    ``meta`` is written first, atomically: a crash between the two leaves
    a sidecar for a step :func:`latest_step` never reports, which is
    harmless; the reverse order could leave a restorable step without its
    host-side state."""
    os.makedirs(directory, exist_ok=True)
    if meta is not None:
        path = _meta_path(directory, step)
        with open(path + ".tmp", "w") as f:
            json.dump(meta, f)
        os.replace(path + ".tmp", path)
    _atomic_save(payload, _path(directory, step))
    for old in _steps(directory)[:-MAX_TO_KEEP]:
        os.remove(_path(directory, old))
        if os.path.exists(_meta_path(directory, old)):
            os.remove(_meta_path(directory, old))


def latest_step(directory: str) -> int | None:
    """Newest saved step in ``directory``, or None."""
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore_payload(directory: str, step: int | None = None):
    """``(payload, step)`` of the newest (or the given) step, tensors on
    the CPU; ``(None, None)`` when nothing is saved."""
    if step is None:
        step = latest_step(directory)
    if step is None:
        return None, None
    return torch.load(_path(directory, step), map_location="cpu", weights_only=True), step


def load_meta(directory: str, step: int) -> dict | None:
    path = _meta_path(directory, step)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def save(directory: str, train_state, step: int) -> None:
    """Nets, optimizer and ``grad_steps`` as step ``step``."""
    save_payload(directory, train_state_dict(train_state), step)


def restore(directory: str, train_state):
    """Load the newest step into ``train_state`` in place; returns
    ``(train_state, step)``, or ``(None, None)`` when nothing is saved."""
    state, step = restore_payload(directory)
    if state is None:
        return None, None
    return load_train_state(train_state, state), step


def save_full(directory: str, train_state, env_state, buffer, generator: torch.Generator,
              step: int, meta: dict | None = None) -> None:
    """Full actor-learner resume point: the train state, the env batch
    (a ``PlanesState``), the replay ring (a ``ReplayBuffer``) and the
    generator's state."""
    save_payload(directory, {
        "train_state": train_state_dict(train_state),
        "env_state": env_state._asdict(),
        "buffer": buffer._asdict(),
        "generator": generator.get_state(),
    }, step, meta)


def restore_full(directory: str, train_state, generator: torch.Generator):
    """Restore the newest full resume point: ``train_state`` and
    ``generator`` in place; returns ``(payload, step)`` with the env batch
    and the ring moved to the generator's device, or ``(None, None)``."""
    payload, step = restore_payload(directory)
    if payload is None:
        return None, None
    load_train_state(train_state, payload["train_state"])
    generator.set_state(payload["generator"])
    dev = generator.device
    for part in ("env_state", "buffer"):
        payload[part] = {k: v.to(dev) if isinstance(v, torch.Tensor) else v
                         for k, v in payload[part].items()}
    return payload, step


def save_az(directory: str, az_state, step: int, generator: torch.Generator | None = None) -> None:
    """An AlphaZero ``AZState`` (net, optimizer, env batch) as step
    ``step``; with ``generator``, its state too: a full resume point."""
    payload = {"net": az_state.net.state_dict(), "optimizer": az_state.optimizer.state_dict(),
               "env_state": az_state.env_state._asdict()}
    if generator is not None:
        payload["generator"] = generator.get_state()
    save_payload(directory, payload, step)


def restore_az(directory: str, az_state, generator: torch.Generator | None = None) -> int | None:
    """Load the newest :func:`save_az` step into ``az_state`` (the env batch
    on the net's device) and, if given, ``generator``, in place; returns
    the step, or None when nothing is saved."""
    payload, step = restore_payload(directory)
    if payload is None:
        return None
    if generator is not None and "generator" not in payload:
        raise RuntimeError(f"checkpoint step {step} in {directory!r} holds no generator "
                           f"state; cannot resume bit-exactly")
    az_state.net.load_state_dict(payload["net"])
    az_state.optimizer.load_state_dict(payload["optimizer"])
    dev = next(az_state.net.parameters()).device
    az_state.env_state = PlanesState(**{k: v.to(dev) for k, v in payload["env_state"].items()})
    if generator is not None:
        generator.set_state(payload["generator"])
    return step


def save_ppo(directory: str, ppo_state, generator: torch.Generator, pool: list, step: int,
             meta: dict | None = None) -> None:
    """A PPO resume point: ``ppo_state``'s nets, optimizers and env
    batches, the generator's state and the league ``pool``."""
    save_payload(directory, {
        "nets": [net.state_dict() for net in ppo_state.nets],
        "optimizers": [opt.state_dict() for opt in ppo_state.optimizers],
        "env_states": [env._asdict() for env in ppo_state.env_states],
        "generator": generator.get_state(),
        "pool": pool,
    }, step, meta)


def restore_ppo(directory: str, ppo_state, generator: torch.Generator,
                step: int | None = None) -> list:
    """Load a :func:`save_ppo` step (the newest if ``step`` is None) into
    ``ppo_state`` and ``generator`` in place (tensors on the generator's
    device); returns the league pool."""
    payload, step = restore_payload(directory, step)
    if payload is None:
        raise FileNotFoundError(f"no checkpoint in {directory!r}")
    dev = generator.device
    for net, sd in zip(ppo_state.nets, payload["nets"]):
        net.load_state_dict(sd)
    for opt, sd in zip(ppo_state.optimizers, payload["optimizers"]):
        opt.load_state_dict(sd)
    ppo_state.env_states = [PlanesState(**{k: v.to(dev) for k, v in env.items()})
                            for env in payload["env_states"]]
    generator.set_state(payload["generator"])
    return [{k: v.to(dev) for k, v in sd.items()} for sd in payload["pool"]]


def save_params(path: str, net: torch.nn.Module) -> None:
    """Standalone dump of one net's parameters."""
    _atomic_save(net.state_dict(), os.path.abspath(path))


def load_params(path: str, net: torch.nn.Module) -> torch.nn.Module:
    """Load :func:`save_params`'s file into ``net`` in place."""
    net.load_state_dict(torch.load(os.path.abspath(path), map_location="cpu",
                                   weights_only=True))
    return net
