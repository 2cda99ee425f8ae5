"""Data-parallel AlphaZero training iteration over the env group.

Port of ``gobblet_rl_tpu/parallel/sharded_alphazero.py``.  Each rank owns
a block of the self-play game batch, runs the batched search locally (the
search has no cross-game state), backfills outcomes and runs the update
phase of ``train/alphazero.py`` on its own segment; each update averages
the gradients over the env group (one ``all_reduce``) BEFORE the global-
norm clip and the replicated AdamW step, as optax clips the averaged
gradients.  Params and optimizer state are replicated; the env state is
the rank's block of the trailing batch axis; randomness is the rank's own
generator (``mesh.rank_generator``).
"""

from __future__ import annotations

import dataclasses

import torch

from gobblet_rl_torch.parallel.mesh import ENV_AXIS, GradSync, axis_size
from gobblet_rl_torch.train import alphazero as az


def make_sharded_az_iteration(config: az.AZConfig, mesh):
    """Returns ``train_iteration(st, generator, noise=None, perm=None) ->
    stats``: one segment, the backfill and the update phase on this rank's
    block ``st.env_state``, updating ``st`` in place.  ``noise`` (the
    Gumbel segment's root fields) and ``perm`` (the update phase's
    permutation) replace the generator's draws, as in ``train/alphazero.py``.
    ``stats``: loss, policy_loss, value_loss and valid_frac averaged over
    the ranks, episodes summed.

    ``config.num_envs`` and ``batch_size`` are GLOBAL sizes; ``num_envs``
    must divide by the mesh's env-axis size."""
    n_env = axis_size(mesh, ENV_AXIS)
    assert config.num_envs % n_env == 0, (config.num_envs, n_env)
    local = dataclasses.replace(
        config,
        num_envs=config.num_envs // n_env,
        batch_size=max(1, config.batch_size // n_env),
    )
    sync = GradSync(mesh.get_group(ENV_AXIS))
    segment = az.make_selfplay_segment(local)
    update_phase = az.make_update_phase(local, grad_sync=sync)

    def train_iteration(st: az.AZState, generator, noise=None, perm=None):
        extra = {} if noise is None else {"noise": noise}
        env_state, traj = segment(st.net, st.env_state, generator, **extra)
        bootstrap = traj.get("v_signed") if local.bootstrap_unfinished else None
        z, valid = az.assign_outcomes(traj["done"], traj["winner"], traj["player"], bootstrap)
        flat = az.flatten_segment(traj, z, valid)
        losses, p_ls, v_ls = update_phase(st.net, st.optimizer, flat, generator, perm)
        st.env_state = env_state
        # one collective for the stats: the means divide after the sum
        total = sync.sum(losses.mean(), p_ls.mean(), v_ls.mean(),
                         valid.to(torch.float32).mean(), traj["done"].sum())
        loss, p_l, v_l, valid_frac = (x / n_env for x in total[:4])
        return {"loss": loss, "policy_loss": p_l, "value_loss": v_l,
                "episodes": total[4].to(torch.int64), "valid_frac": valid_frac}

    return train_iteration
