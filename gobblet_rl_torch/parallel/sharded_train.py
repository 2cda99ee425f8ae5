"""Data-parallel DQN training iteration over the env group.

Port of ``gobblet_rl_tpu/parallel/sharded_train.py``.  Each rank owns a
block of the env batch and of the replay ring, runs collect + n-step fold
+ insert into its own ring, one sample for all ``update_per_collect``
minibatches and that many updates of the port's ``train/dqn.py``; each
update averages the gradients and the loss over the env group in one
``all_reduce`` (:class:`~gobblet_rl_torch.parallel.mesh.GradSync`) before
the replicated Adam step, so every rank applies the same update.

Layout:

* ``TrainState`` (nets, target, optimizer): replicated, built identically
  on every rank;
* ``PlanesState``: the rank's block of the trailing (batch) axis;
* ``ReplayBuffer``: the rank's block of the rows; ``cursor`` and
  ``filled`` are per-rank counters, identical on every rank (each inserts
  the same count);
* randomness: the rank's own generator (``mesh.rank_generator``).
"""

from __future__ import annotations

import dataclasses

from gobblet_rl_torch.parallel.mesh import ENV_AXIS, GradSync, axis_size, local_block
from gobblet_rl_torch.train import dqn as dqn_mod
from gobblet_rl_torch.train import replay


def _buffer_specs(buffer: replay.ReplayBuffer) -> replay.ReplayBuffer:
    """Rows over the env axis; ``cursor``/``filled`` are per-rank counters
    that stay identical across ranks, so they are declared replicated."""
    specs = [(ENV_AXIS,) + (None,) * (x.dim() - 1) for x in buffer[:-2]]
    return replay.ReplayBuffer(*specs, cursor=(), filled=())


def shard_buffer(buffer: replay.ReplayBuffer, mesh) -> replay.ReplayBuffer:
    """This rank's block of a globally sized ring under ``_buffer_specs``;
    the counters are kept."""
    specs = _buffer_specs(buffer)
    return replay.ReplayBuffer(*(local_block(x, spec, mesh) for x, spec in
                                 zip(buffer[:-2], specs[:-2])), *buffer[-2:])


def local_config(config: dqn_mod.DQNConfig, mesh) -> dqn_mod.DQNConfig:
    """``config`` with the GLOBAL ``num_envs``, ``buffer_size`` and
    ``batch_size`` divided by the env-axis size (each must divide)."""
    n_env = axis_size(mesh, ENV_AXIS)
    assert config.num_envs % n_env == 0
    assert config.buffer_size % n_env == 0
    assert config.batch_size % n_env == 0
    return dataclasses.replace(
        config,
        num_envs=config.num_envs // n_env,
        buffer_size=config.buffer_size // n_env,
        batch_size=config.batch_size // n_env,
    )


def make_sharded_train_iteration(config: dqn_mod.DQNConfig, mesh):
    """Returns ``(train_iteration, opponent_fn)``;
    ``train_iteration(ts, env_state, buffer, generator, mark=None)`` takes
    this rank's blocks (``mesh.shard_env_state``, ``shard_buffer``) and its own
    generator and returns ``(env_state, buffer, loss)``, the loss averaged
    over the env group, updating ``ts`` and the ring in place.

    ``config.num_envs``, ``buffer_size`` and ``batch_size`` are GLOBAL
    sizes and must divide by the mesh's env-axis size.  JAX's sharded
    update has no defense term, and neither has this one."""
    return dqn_mod.make_train_iteration(local_config(config, mesh),
                                        grad_sync=GradSync(mesh.get_group(ENV_AXIS)))
