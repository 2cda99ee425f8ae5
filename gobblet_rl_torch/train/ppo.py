"""Self-play PPO with masked policies, on the card.

Port of ``gobblet_rl_tpu/train/ppo.py``:

* two nets (player_1 / player_2, alternating learner and frozen roles each
  iteration, pure self-play) or one shared net (``shared_policy=True``);
* a learner-centric MDP: each env advances the learner's ply and the
  opponent's reply inside the collect; the learner seat of each env is
  pinned (0 / 1) or alternates even / odd envs (``learner_player="both"``);
* frozen opponents: "self" (the learner's own net), "random", "greedy"
  (the batched depth-1/2 lookahead), "pool" (a league of past snapshots),
  "search" (the zoo's AlphaZero net behind the lane-major Gumbel search)
  and "mixed" (a draw over random / greedy / pool [/ search] each
  iteration, from ``np.random.default_rng(seed)`` as in the JAX trainer);
* GAE(lambda) over the learner's own timeline, the clipped surrogate, the
  value loss and the masked entropy bonus, plus, with
  ``defense_bc_weight > 0``, the cross-entropy to the solver's labels over
  the whole defense bank (``train/defense.py``);
* ``clip_by_global_norm(max_grad_norm)`` then Adam, ``epochs_per_iter``
  epochs of ``minibatches`` minibatches over one permutation an epoch.

The nets are ``nn.Module``s held in a mutable :class:`PPOState`; all device
randomness comes from one explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gobblet_rl_torch import zoo
from gobblet_rl_torch.device import resolve_device
from gobblet_rl_torch.models import actor_critic as ac
from gobblet_rl_torch.ops import batched_core as bc
from gobblet_rl_torch.policies import greedy_jax
from gobblet_rl_torch.search import gumbel, gumbel_lm
from gobblet_rl_torch.train import checkpoint as ckpt
from gobblet_rl_torch.train import defense
from gobblet_rl_torch.train.alphazero import clip_by_global_norm_
from gobblet_rl_torch.train.dqn import _obs_bf, _seat_reward, _sel, seat_array


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """Same fields, defaults and validation as the JAX package's
    ``PPOConfig``."""

    seed: int = 42
    lr: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    epochs_per_iter: int = 4
    minibatches: int = 8
    segment_len: int = 32
    num_envs: int = 512
    iterations: int = 64
    hidden_sizes: tuple = (128, 128)
    shared_policy: bool = False
    model: str = "mlp"   # "mlp" | "conv"
    max_grad_norm: float = 0.5
    # the learner's seat(s) in shared-policy mode: 0, 1 or "both"
    # (alternating even / odd envs); non-shared mode alternates the trained
    # side each iteration
    learner_player: int | str = 0
    # "self" | "random" | "greedy" | "pool" | "search" | "mixed"
    opponent: str = "self"
    greedy_depth: int = 2
    pool_size: int = 8        # snapshots kept by the league
    pool_every: int = 4       # iterations between snapshot pushes
    mixed_weights: tuple = (0.25, 0.25, 0.5)   # P(random, greedy, pool[, search])
    search_sims: int = 8      # Gumbel simulations of the "search" attacker
    search_entry: str = "alphazero_gumbel32"   # the zoo entry it plays with
    # > 0 adds the behaviour-cloning term over the defense bank
    defense_bc_weight: float = 0.0
    defense_bank_games: int = 256
    defense_bank_depth: int = 16
    # "defense" labels the defender's positions; "both" the attacker's too
    defense_bank_sides: str = "defense"

    def __post_init__(self):
        if not self.shared_policy and self.opponent != "self":
            raise ValueError(
                "non-shared (alternating two-policy) mode is pure self-play; "
                f"set shared_policy=True to use opponent={self.opponent!r}")
        if self.opponent == "mixed" and len(self.mixed_weights) not in (3, 4):
            raise ValueError(
                "mixed_weights must have 3 entries (random, greedy, pool) or "
                f"4 (+ search); got {self.mixed_weights!r}")


@dataclasses.dataclass
class PPOState:
    """The two nets, their optimizers and the per-role env batches (batch
    ``r`` is kept at role ``r``'s turn).  In shared mode both roles hold
    the same net, and only role 0's optimizer and env batch advance."""

    nets: list
    optimizers: list
    env_states: list


def make_net(config: PPOConfig, device=None) -> torch.nn.Module:
    if config.model == "conv":
        return ac.ConvActorCritic(device=device)
    return ac.MLPActorCritic(hidden_sizes=tuple(config.hidden_sizes), device=device)


def make_optimizer(config: PPOConfig, net: torch.nn.Module) -> torch.optim.Optimizer:
    """Adam with optax's defaults (the gradient clip is applied by the
    update, before each step)."""
    return torch.optim.Adam(net.parameters(), lr=config.lr, betas=(0.9, 0.999), eps=1e-8)


def _resolve_kind(config: PPOConfig, kind: str | None) -> str:
    """The opponent a rollout runs: ``pool`` and ``mixed`` are host-level
    choices over the random / greedy / self / search variants."""
    kind = kind if kind is not None else config.opponent
    return "self" if kind in ("self", "pool", "mixed") else kind


def make_opponent_fn(config: PPOConfig, kind: str | None = None, device=None):
    """``(generator, board, current, opp_net, noise=None) -> int32[B]``
    opponent actions.  ``noise`` replaces the generator's draw: a float32
    [54, B] field for random, greedy and search (the search's root
    Gumbel field), [B, 54] for self."""
    kind = _resolve_kind(config, kind)
    if kind == "random":

        def fn(generator, board, current, opp_net, noise=None):
            return bc.sample_random_lm(generator, bc.legal_mask_planes(board, current), noise)

    elif kind == "greedy":

        def fn(generator, board, current, opp_net, noise=None):
            return greedy_jax.greedy_actions(generator, board, current, config.greedy_depth,
                                             gumbel=noise)

    elif kind == "self":

        @torch.no_grad()
        def fn(generator, board, current, opp_net, noise=None):
            logits, _ = opp_net(_obs_bf(board, current))
            mask = bc.legal_mask_planes(board, current).t()
            return ac.sample_masked(generator, logits, mask, gumbel=noise)[0]

    elif kind == "search":
        # the zoo's AlphaZero net, frozen; opp_net (the learner's) is unused
        az_net, _, _ = zoo.load(config.search_entry, expect_family="alphazero",
                                device=resolve_device(device))
        gcfg = gumbel.GumbelConfig(num_sims=config.search_sims,
                                   max_considered=min(16, max(2, config.search_sims)))

        def fn(generator, board, current, opp_net, noise=None):
            return gumbel_lm.gumbel_search_lm(az_net, board, current, generator, gcfg,
                                              noise=noise)[0]

    else:
        raise ValueError(f"unknown opponent {kind!r}")
    return fn


def _select(need, a: bc.PlanesState, b: bc.PlanesState) -> bc.PlanesState:
    return bc.PlanesState(*(_sel(need, x, y) for x, y in zip(a, b)))


def make_learner_rollout(config: PPOConfig, opponent_fn):
    """``rollout(net, opp_net, env_state, generator, lp, noise=None) ->
    (env_state, traj, last_value)``: a segment of ``segment_len`` learner
    transitions with the opponent frozen.  ``traj`` holds [L, B, ...]
    obs, mask, action, logp, value, reward and done; ``lp`` is the learner
    seat spec (0, 1 or "both").

    ``noise``, optional, replaces every draw with a per-ply field: ``act``
    float32 [L, B, 54] (the learner's categorical draw), ``opp`` [L, ...]
    (the opponent's reply) and ``open`` [L, ...] (its opening move after a
    reset, where the learner sits second), each in the opponent's form."""

    def learner_step(state, actions, generator, opp_net, lp, noise_opp, noise_open):
        seat = seat_array(lp, state.current.shape[0], state.current.device)
        s1 = bc.step_trusted(state, actions)
        r = _seat_reward(s1.rewards, seat)
        a_opp = opponent_fn(generator, s1.board, s1.current, opp_net, noise_opp)
        s2 = bc.step_trusted(s1, a_opp)  # frozen no-op where s1.done
        r = r + _seat_reward(s2.rewards, seat)
        done = s2.done
        s3 = bc.autoreset_planes(s2)
        if lp != 0:
            # after a reset player 0 opens; envs whose learner seat is 1
            # need the opponent to move first
            need = s3.current != seat
            a0 = opponent_fn(generator, s3.board, s3.current, opp_net, noise_open)
            s3 = _select(need, bc.step_trusted(s3, a0), s3)
        return s3, r, done

    @torch.no_grad()
    def rollout(net, opp_net, env_state, generator, lp, noise=None):
        L, B, dev = config.segment_len, env_state.current.shape[0], env_state.current.device
        traj = {
            "obs": torch.empty((L, B, 117), dtype=torch.int8, device=dev),
            "mask": torch.empty((L, B, 54), dtype=torch.bool, device=dev),
            "action": torch.empty((L, B), dtype=torch.int32, device=dev),
            "logp": torch.empty((L, B), dtype=torch.float32, device=dev),
            "value": torch.empty((L, B), dtype=torch.float32, device=dev),
            "reward": torch.empty((L, B), dtype=torch.float32, device=dev),
            "done": torch.empty((L, B), dtype=torch.bool, device=dev),
        }
        for t in range(L):
            n = {} if noise is None else {k: v[t] for k, v in noise.items()}
            obs = _obs_bf(env_state.board, env_state.current)
            mask = bc.legal_mask_planes(env_state.board, env_state.current).t()
            logits, value = net(obs)
            action, logp = ac.sample_masked(generator, logits, mask, gumbel=n.get("act"))
            traj["obs"][t], traj["mask"][t], traj["action"][t] = obs, mask, action
            traj["logp"][t], traj["value"][t] = logp, value
            env_state, traj["reward"][t], traj["done"][t] = learner_step(
                env_state, action, generator, opp_net, lp, n.get("opp"), n.get("open"))
        _, last_value = net(_obs_bf(env_state.board, env_state.current))
        return env_state, traj, last_value

    return rollout


def compute_gae(traj: dict, last_value: torch.Tensor, gamma: float, lam: float):
    """GAE over the learner's timeline; a finished game cuts the
    recursion.  Returns ``(advantages, returns)``, float32 [L, B]."""
    value, reward = traj["value"], traj["reward"]
    nonterminal = 1.0 - traj["done"].to(torch.float32)
    adv = torch.empty_like(value)
    gae = torch.zeros_like(last_value)
    next_value = last_value
    for t in reversed(range(value.shape[0])):
        delta = reward[t] + gamma * next_value * nonterminal[t] - value[t]
        gae = delta + gamma * lam * nonterminal[t] * gae
        adv[t], next_value = gae, value[t]
    return adv, adv + value


def make_loss_fn(config: PPOConfig, defense_bank: dict | None = None):
    """``loss_fn(net, batch) -> (total, (pg_loss, v_loss, entropy))`` over a
    minibatch of obs / mask / action / logp / adv / ret rows; the
    advantages are normalised with the population std, as ``jnp.std``."""

    def loss_fn(net, batch):
        logits, value = net(batch["obs"])
        logp, entropy = ac.logp_entropy(logits, batch["mask"], batch["action"])
        ratio = torch.exp(logp - batch["logp"])
        adv = batch["adv"]
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        clipped = torch.clamp(ratio, 1 - config.clip_eps, 1 + config.clip_eps) * adv
        pg_loss = -torch.minimum(ratio * adv, clipped).mean()
        v_loss = ((value - batch["ret"]) ** 2).mean()
        ent = entropy.mean()
        total = pg_loss + config.vf_coef * v_loss - config.ent_coef * ent
        if defense_bank is not None:
            # the whole (small, fixed) bank every update
            total = total + config.defense_bc_weight * defense.bank_loss(
                net(defense_bank["obs"])[0], defense_bank)
        return total, (pg_loss, v_loss, ent)

    return loss_fn


def make_train_iteration(config: PPOConfig, opponent_kind: str | None = None,
                         defense_bank: dict | None = None, device=None):
    """``train_iteration(net, opp_net, optimizer, env_state, generator, lp,
    noise=None, perms=None, mark=None) -> (env_state, stats)``: one segment
    against the ``opponent_kind`` opponent, GAE, then ``epochs_per_iter``
    epochs of ``minibatches`` updates of ``net`` in place.  Epoch ``e``
    trains on ``perms[e]`` (drawn from ``generator`` unless given); the
    rollout's ``noise`` is :func:`make_learner_rollout`'s.  ``mark``, if
    given, is called with "rollout", "gae" and "updates" as each phase has
    been issued (a timer's hook).  ``stats`` are device scalars."""
    rollout = make_learner_rollout(config, make_opponent_fn(config, opponent_kind, device))
    loss_fn = make_loss_fn(config, defense_bank)

    def train_iteration(net, opp_net, optimizer, env_state, generator, lp, noise=None,
                        perms=None, mark=None):
        mark = mark or (lambda phase: None)
        env_state, traj, last_value = rollout(net, opp_net, env_state, generator, lp, noise)
        mark("rollout")
        with torch.no_grad():
            adv, ret = compute_gae(traj, last_value, config.gamma, config.gae_lambda)
        n = adv.numel()
        flat = {
            "obs": traj["obs"].reshape(n, -1),
            "mask": traj["mask"].reshape(n, -1),
            "action": traj["action"].reshape(n),
            "logp": traj["logp"].reshape(n),
            "adv": adv.reshape(n),
            "ret": ret.reshape(n),
        }
        mark("gae")
        mb = n // config.minibatches
        losses = []
        for e in range(config.epochs_per_iter):
            perm = (perms[e] if perms is not None
                    else torch.randperm(n, generator=generator, device=adv.device))
            for i in range(config.minibatches):
                idx = perm[i * mb:(i + 1) * mb]
                loss, _ = loss_fn(net, {k: v[idx] for k, v in flat.items()})
                optimizer.zero_grad(set_to_none=True)
                loss.backward()
                clip_by_global_norm_(net.parameters(), config.max_grad_norm)
                optimizer.step()
                losses.append(loss.detach())
        mark("updates")
        done = traj["done"]
        episodes = done.sum()
        stats = {
            # the mean over epochs of each epoch's mean: the minibatches are
            # equal in number, so the mean of all of them
            "loss": torch.stack(losses).mean(),
            "episodes": episodes,
            "mean_reward": (traj["reward"] * done).sum() / episodes.clamp(min=1),
        }
        return env_state, stats

    return train_iteration


def init_env_state(config: PPOConfig, opponent_fn, opp_net, generator: torch.Generator,
                   lp) -> bc.PlanesState:
    """A fresh env batch on the generator's device, advanced to the learner
    seat's turn everywhere."""
    state = bc.reset_planes(config.num_envs, generator.device)
    if lp == 0:
        return state
    seat = seat_array(lp, config.num_envs, generator.device)
    a0 = opponent_fn(generator, state.board, state.current, opp_net)
    return _select(state.current != seat, bc.step_planes(state, a0), state)


def init_ppo(config: PPOConfig, generator: torch.Generator) -> PPOState:
    """Both nets initialised from ``generator`` (on its device; one net in
    shared mode), their optimizers and the env batches."""
    dev = generator.device
    p0 = make_net(config, dev)
    p0.reset_parameters(generator)
    if config.shared_policy:
        p1 = p0
    else:
        p1 = make_net(config, dev)
        p1.reset_parameters(generator)
    opponent_fn = make_opponent_fn(config, device=dev)
    # shared mode plays role 0 only: no second env batch to build
    lp0 = config.learner_player if config.shared_policy else 0
    env0 = init_env_state(config, opponent_fn, p1, generator, lp0)
    env1 = env0 if config.shared_policy else init_env_state(config, opponent_fn, p0,
                                                             generator, 1)
    return PPOState(nets=[p0, p1],
                    optimizers=[make_optimizer(config, p0), make_optimizer(config, p1)],
                    env_states=[env0, env1])


def snapshot(net: torch.nn.Module) -> dict:
    """A detached copy of ``net``'s state dict (a league entry)."""
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def train(config: PPOConfig = PPOConfig(), logger=None, full_resume_dir: str | None = None,
          device=None):
    """PPO training; returns ``(PPOState, history)``.

    ``shared_policy=False``: two nets alternate the learner and frozen
    roles each iteration, pure self-play.  ``shared_policy=True``: one net
    trains on the seat(s) of ``learner_player`` against ``opponent``;
    ``pool`` and the pool leg of ``mixed`` draw a frozen past snapshot each
    iteration.

    ``full_resume_dir`` saves a complete resume point every iteration (both
    nets and optimizers, both env batches, the generator, the league pool,
    and the opponent draw's numpy generator in the meta sidecar) and, at
    start, restores the newest one: a run preempted and relaunched with the
    same config ends bit-identical to an uninterrupted one."""
    dev = resolve_device(device)
    generator = torch.Generator(device=dev)
    generator.manual_seed(config.seed)
    st = init_ppo(config, generator)
    rng = np.random.default_rng(config.seed)
    bank = None
    if config.defense_bc_weight > 0:
        bank = defense.bank_tensors(defense.generate_defense_bank(
            num_games=config.defense_bank_games, seed=config.seed,
            depth=config.defense_bank_depth, sides=config.defense_bank_sides, device=dev), dev)
    if config.shared_policy:
        if config.opponent == "mixed":
            kinds = ("random", "greedy", "self", "search")[:len(config.mixed_weights)]
        else:
            kinds = (_resolve_kind(config, None),)
        pool = [snapshot(st.nets[0])]  # the league's seed: the untrained net
    else:
        kinds, pool = ("self",), []
    its = {k: make_train_iteration(config, k, bank, dev) for k in kinds}
    opp_net = make_net(config, dev)  # holds the pool snapshot an iteration plays

    start = 0
    if full_resume_dir is not None:
        step = ckpt.latest_step(full_resume_dir)
        if step is not None:
            meta = ckpt.load_meta(full_resume_dir, step)
            if meta is None:
                raise RuntimeError(
                    f"checkpoint step {step} in {full_resume_dir!r} has no "
                    f"meta-{step}.json sidecar; cannot resume bit-exactly")
            pool = ckpt.restore_ppo(full_resume_dir, st, generator, step)
            rng.bit_generator.state = meta["rng_state"]
            start = step + 1

    history = []
    for i in range(start, config.iterations):
        if config.shared_policy:
            lp, role = config.learner_player, 0
            if config.opponent == "mixed":
                choices = ["random", "greedy", "pool", "search"][:len(config.mixed_weights)]
                kind = str(rng.choice(choices, p=list(config.mixed_weights)))
            else:
                kind = config.opponent
            opp = st.nets[0]   # the learner itself; unused by random/greedy/search
            if kind == "pool":
                opp_net.load_state_dict(pool[int(rng.integers(len(pool)))])
                opp, kind = opp_net, "self"
        else:
            lp = role = i % 2
            kind, opp = "self", st.nets[1 - role]
        st.env_states[role], stats = its[kind](
            st.nets[role], opp, st.optimizers[role], st.env_states[role], generator, lp)
        if config.shared_policy:
            if config.opponent in ("pool", "mixed") and (i + 1) % config.pool_every == 0:
                pool.append(snapshot(st.nets[0]))
                if len(pool) > config.pool_size:
                    pool.pop(0)
        record = {
            "iteration": i,
            "learner": lp,
            "opponent": kind if config.shared_policy else "self",
            "loss": stats["loss"].item(),
            "episodes": int(stats["episodes"]),
            "mean_reward": stats["mean_reward"].item(),
        }
        history.append(record)
        if logger is not None:
            logger.log(record)
        if full_resume_dir is not None:
            ckpt.save_ppo(full_resume_dir, st, generator, pool, i,
                          meta={"pool_len": len(pool), "rng_state": rng.bit_generator.state})
    return st, history
