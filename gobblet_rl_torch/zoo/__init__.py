"""Trained-agent zoo: the committed agents, loaded into torch modules.

Port of ``gobblet_rl_tpu/zoo/__init__.py`` for the ``dqn``, ``alphazero``
and ``ppo`` families.  The agents are the flax-serialized parameter
blobs and the ``manifest.json`` committed in ``gobblet_rl_tpu/zoo/``; this
module reads them by path (or from ``$GOBBLET_ZOO_DIR``), decodes them with
its own msgpack reader (:mod:`gobblet_rl_torch.zoo.flax_msgpack`) and
carries the weights across with :mod:`gobblet_rl_torch.models.convert`:

    from gobblet_rl_torch import zoo
    net, params, meta = zoo.load("alphazero_gumbel32")   # ConvActorCritic on the card
    policy = zoo.policy("alphazero_gumbel32")            # eval/tournament policy
    agent = zoo.host_agent("alphazero_gumbel32")         # GameSession-compatible

:func:`save` writes an entry the JAX package's ``zoo.load`` reads, with
the port's own msgpack writer; it writes only into ``$GOBBLET_ZOO_DIR``,
never into the committed zoo.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np
import torch

from gobblet_rl_torch.device import resolve_device
from gobblet_rl_torch.eval import tournament
from gobblet_rl_torch.models import actor_critic as ac
from gobblet_rl_torch.models.convert import (actor_critic_params_from_flax,
                                             actor_critic_params_to_flax, qnet_params_from_flax,
                                             qnet_params_to_flax)
from gobblet_rl_torch.models.mlp import QNet
from gobblet_rl_torch.policies.greedy import board_from_observation
from gobblet_rl_torch.train import alphazero
from gobblet_rl_torch.utils import profiling
from gobblet_rl_torch.zoo import flax_msgpack


_COMMITTED = Path(__file__).resolve().parents[2] / "gobblet_rl_tpu" / "zoo"


def _zoo_dir() -> str:
    """The committed zoo of the JAX package, or ``$GOBBLET_ZOO_DIR``."""
    return os.environ.get("GOBBLET_ZOO_DIR", str(_COMMITTED))


def _manifest() -> Dict[str, Any]:
    path = os.path.join(_zoo_dir(), "manifest.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def names() -> list:
    """Available zoo entries (sorted)."""
    return sorted(_manifest())


def meta(name: str) -> Dict[str, Any]:
    m = _manifest()
    if name not in m:
        raise KeyError(f"unknown zoo entry {name!r}; available: {sorted(m) or 'none'}")
    return m[name]


def load(name: str, expect_family: str | None = None,
         device=None) -> Tuple[Any, Dict[str, Any], Dict[str, Any]]:
    """``(net, params, meta)`` for a zoo entry: the torch module on
    ``device`` (``None``: the CUDA card, or raise) with the weights loaded,
    the flax parameter tree as numpy arrays, and the manifest row.

    ``expect_family`` guards against loading another family's agent."""
    entry = meta(name)
    family = entry["family"]
    if expect_family is not None and family != expect_family:
        raise ValueError(
            f"zoo entry {name!r} is family {family!r}, but this loader expects "
            f"{expect_family!r}; pick one of "
            f"{[n for n in names() if meta(n)['family'] == expect_family] or 'none'}")
    if family not in ("dqn", "alphazero", "ppo"):
        raise ValueError(f"unknown zoo family {family!r}")

    with open(os.path.join(_zoo_dir(), entry["file"]), "rb") as f:
        params = flax_msgpack.msgpack_restore(f.read())
    net_cfg = entry["net"]
    if family == "dqn":
        net = QNet(hidden_sizes=tuple(net_cfg["hidden_sizes"]), dueling=net_cfg["dueling"],
                   device=device)
        net.load_state_dict(qnet_params_from_flax(params, dueling=net_cfg["dueling"]))
    elif family == "ppo":
        net = ac.MLPActorCritic(hidden_sizes=tuple(net_cfg["hidden_sizes"]), device=device)
        net.load_state_dict(actor_critic_params_from_flax(params, "mlp"))
    else:
        if net_cfg["model"] == "conv":
            net = ac.ConvActorCritic(channels=net_cfg["channels"], blocks=net_cfg["blocks"],
                                     device=device)
        else:
            net = ac.MLPActorCritic(hidden_sizes=tuple(net_cfg["hidden_sizes"]), device=device)
        net.load_state_dict(actor_critic_params_from_flax(params, net_cfg["model"]))
    return net, params, entry


def save(name: str, net: torch.nn.Module, entry: Dict[str, Any]) -> None:
    """Write a zoo entry: ``net``'s weights as a flax msgpack blob and its
    manifest row (``entry``, with ``file`` defaulting to
    ``<name>.msgpack``).  Safe to call repeatedly (overwrites).  Writes
    only into ``$GOBBLET_ZOO_DIR``, and raises if it is unset or names the
    committed zoo."""
    target = os.environ.get("GOBBLET_ZOO_DIR")
    if not target:
        raise RuntimeError("zoo.save writes into $GOBBLET_ZOO_DIR, which is unset")
    if Path(target).resolve() == _COMMITTED:
        raise RuntimeError(f"zoo.save does not write into the committed zoo {_COMMITTED}")
    entry = dict(entry)
    entry.setdefault("file", f"{name}.msgpack")
    family, net_cfg, sd = entry["family"], entry["net"], net.state_dict()
    if family == "dqn":
        tree = qnet_params_to_flax(sd, dueling=net_cfg["dueling"])
    elif family in ("alphazero", "ppo"):
        tree = actor_critic_params_to_flax(sd, net_cfg.get("model", "mlp"))
    else:
        raise ValueError(f"unknown zoo family {family!r}")
    os.makedirs(target, exist_ok=True)
    with open(os.path.join(target, entry["file"]), "wb") as f:
        f.write(flax_msgpack.msgpack_serialize(tree))
    m = _manifest()
    m[name] = entry
    # atomic replace: a crash mid-dump must not corrupt the manifest that
    # every load and names call reads
    path = os.path.join(target, "manifest.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(m, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def policy(name: str, device=None, **overrides):
    """Tournament policy ``(generator, board, current) -> actions`` of a
    zoo entry; ``overrides`` tune its evaluation: ``num_sims``/``c_puct``
    for alphazero (over the manifest's ``eval`` row), ``eps`` for dqn,
    ``sample`` for ppo."""
    net, _, entry = load(name, device=device)
    if entry["family"] == "alphazero":
        return alphazero.az_policy(net, **{**entry.get("eval", {}), **overrides})
    if entry["family"] == "ppo":
        return tournament.ppo_policy(net, **overrides)
    return tournament.dqn_policy(net, **overrides)


def host_agent(name: str, seed: int = 0, device=None, **overrides):
    """A ``compute_action(obs, mask)`` agent for the host AEC env
    (``GameSession``-compatible, like ``GreedyGobbletPolicy``): the zoo
    policy at B=1 on ``device`` (``None``: the CUDA card, or raise),
    behind the reference's (3, 3, 13) observation.  A ``torch.Generator``
    seeded with ``seed`` feeds the policy's draws; the zoo's evaluation
    policies draw nothing unless ``overrides`` ask for it (``eps`` > 0,
    ``sample=True``).  Traced, a move is the root span ``zoo.move`` around
    ``zoo.decode`` (the observation to a board), ``zoo.upload`` (the board
    and seat to the device), ``zoo.policy`` (the policy's launches) and
    ``zoo.readback`` (the action back to the host)."""
    dev = resolve_device(device)
    pol = policy(name, device=dev, **overrides)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)

    class _ZooAgent:
        def compute_action(self, obs, mask):
            with profiling.annotate("zoo.move"):
                with profiling.annotate("zoo.decode"):
                    board, agent = board_from_observation(np.asarray(obs))
                with profiling.annotate("zoo.upload"):
                    lane_major = torch.from_numpy(board).to(dev)[..., None]      # [3, 9, 1]
                    current = torch.tensor([agent], dtype=torch.int32, device=dev)
                with profiling.annotate("zoo.policy"):
                    actions = pol(generator, lane_major, current)
                with profiling.annotate("zoo.readback"):
                    return int(actions[0])

    return _ZooAgent()
