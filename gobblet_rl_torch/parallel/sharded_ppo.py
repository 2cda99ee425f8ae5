"""Data-parallel PPO iteration over the env group.

Port of ``gobblet_rl_tpu/parallel/sharded_ppo.py``.  Each rank owns a
block of the env batch and runs the rollout, GAE and minibatch updates of
``train/ppo.py`` on it.  Unlike the unsharded iteration, which normalises
the advantages per minibatch, this one normalises them with the moments of
the whole iteration over all ranks (one mean and one variance
``all_reduce``, population std); each update averages the gradients and
the loss over the env group in one ``all_reduce`` BEFORE the global-norm
clip and the replicated Adam step.
"""

from __future__ import annotations

import dataclasses

import torch

from gobblet_rl_torch.models import actor_critic as ac
from gobblet_rl_torch.parallel.mesh import ENV_AXIS, GradSync, axis_size
from gobblet_rl_torch.train import ppo as ppo_mod
from gobblet_rl_torch.train.alphazero import clip_by_global_norm_


def make_sharded_ppo_iteration(config: ppo_mod.PPOConfig, mesh, device=None):
    """Returns ``ppo_iteration(net, opp_net, optimizer, env_state, generator,
    lp, noise=None, perms=None) -> (env_state, stats)``: one segment on this
    rank's block ``env_state`` against ``config.opponent``, then
    ``epochs_per_iter`` epochs of ``minibatches`` updates of ``net`` in
    place.  ``noise`` and ``perms`` replace the generator's draws, as in
    ``train/ppo.py``.  ``stats``: the loss (each update's averaged over the
    ranks), episodes and mean_reward over all ranks.

    ``config.num_envs`` is the GLOBAL env count and must divide by the
    mesh's env-axis size.  ``device`` is the opponent's (the "search"
    opponent loads a zoo net there)."""
    n_env = axis_size(mesh, ENV_AXIS)
    assert config.num_envs % n_env == 0, (config.num_envs, n_env)
    local = dataclasses.replace(config, num_envs=config.num_envs // n_env)
    rollout = ppo_mod.make_learner_rollout(local, ppo_mod.make_opponent_fn(local, device=device))
    sync = GradSync(mesh.get_group(ENV_AXIS))

    def loss_fn(net, batch, adv_mean, adv_std):
        logits, value = net(batch["obs"])
        logp, entropy = ac.logp_entropy(logits, batch["mask"], batch["action"])
        ratio = torch.exp(logp - batch["logp"])
        # the advantage moments are the whole iteration's, over all ranks
        adv = (batch["adv"] - adv_mean) / (adv_std + 1e-8)
        clipped = torch.clamp(ratio, 1 - local.clip_eps, 1 + local.clip_eps) * adv
        pg_loss = -torch.minimum(ratio * adv, clipped).mean()
        v_loss = ((value - batch["ret"]) ** 2).mean()
        return pg_loss + local.vf_coef * v_loss - local.ent_coef * entropy.mean()

    def ppo_iteration(net, opp_net, optimizer, env_state, generator, lp, noise=None,
                      perms=None):
        env_state, traj, last_value = rollout(net, opp_net, env_state, generator, lp, noise)
        with torch.no_grad():
            adv, ret = ppo_mod.compute_gae(traj, last_value, local.gamma, local.gae_lambda)
        n = adv.numel()
        flat = {
            "obs": traj["obs"].reshape(n, -1),
            "mask": traj["mask"].reshape(n, -1),
            "action": traj["action"].reshape(n),
            "logp": traj["logp"].reshape(n),
            "adv": adv.reshape(n),
            "ret": ret.reshape(n),
        }
        # global advantage moments: one mean pair per iteration
        (adv_mean,) = sync.sum(flat["adv"].mean())
        adv_mean = adv_mean / n_env
        (adv_var,) = sync.sum(((flat["adv"] - adv_mean) ** 2).mean())
        adv_std = torch.sqrt(adv_var / n_env)
        mb = n // local.minibatches
        losses = []
        for e in range(local.epochs_per_iter):
            perm = (perms[e] if perms is not None
                    else torch.randperm(n, generator=generator, device=adv.device))
            for i in range(local.minibatches):
                idx = perm[i * mb:(i + 1) * mb]
                loss = loss_fn(net, {k: v[idx] for k, v in flat.items()}, adv_mean, adv_std)
                optimizer.zero_grad(set_to_none=True)
                loss.backward()
                (loss,) = sync(net.parameters(), loss)
                clip_by_global_norm_(net.parameters(), local.max_grad_norm)
                optimizer.step()
                losses.append(loss)
        done = traj["done"]
        episodes, reward_sum = sync.sum(done.sum(), (traj["reward"] * done).sum())
        stats = {
            "loss": torch.stack(losses).mean(),
            "episodes": episodes.to(torch.int64),
            "mean_reward": reward_sum / episodes.clamp(min=1),
        }
        return env_state, stats

    return ppo_iteration
