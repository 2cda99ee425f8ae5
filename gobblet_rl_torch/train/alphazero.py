"""AlphaZero-style training: batched search self-play and policy/value
learning, on the card.

Port of ``gobblet_rl_tpu/train/alphazero.py``.  One shared policy/value
net plays both sides; every ply of every game in the batch is chosen by a
batched search; the net learns the search's policy target and the game
outcome.  One training iteration is:

1. a self-play segment of ``segment_len`` plies, each a root-batched
   search of ``num_sims`` simulations (one net evaluation at width B per
   simulation) and one ``step_trusted`` + ``autoreset_planes`` of the
   lane-major engine;
2. the reverse outcome backfill (:func:`assign_outcomes`);
3. ``updates_per_iter`` minibatched AdamW updates on the flattened segment.

``search="puct"`` (the default, AlphaZero's discipline: root Dirichlet
noise, visit-proportional moves for the first ``temp_moves`` plies of a
game, the visit distribution as the policy target) or ``"gumbel"`` /
``"gumbel_lm"`` (sequential halving: the root Gumbel noise is the
exploration, the completed-Q improved policy is the target, and each
root's mixed value can bootstrap unfinished games).  In this port
``"gumbel"`` and ``"gumbel_lm"`` run the same lane-major search.

The optimizer is ``clip_by_global_norm(max_grad_norm)`` then AdamW with
the weight decay on every parameter (optax's ``adamw`` with ``mask=None``).
All randomness comes from one ``torch.Generator`` on the training device.
"""

from __future__ import annotations

import dataclasses

import torch

from gobblet_rl_torch.device import resolve_device
from gobblet_rl_torch.models import actor_critic as ac
from gobblet_rl_torch.ops import batched_core as bc
from gobblet_rl_torch.search import gumbel, gumbel_lm, mcts, mcts_lm
from gobblet_rl_torch.train import checkpoint as ckpt
from gobblet_rl_torch.train.dqn import _obs_bf


@dataclasses.dataclass(frozen=True)
class AZConfig:
    """Same fields and defaults as the JAX package's ``AZConfig``."""

    seed: int = 42
    lr: float = 2e-3
    weight_decay: float = 1e-4
    max_grad_norm: float = 1.0
    value_coef: float = 1.0
    # self-play
    num_envs: int = 256
    num_sims: int = 64
    search: str = "puct"           # "puct" | "gumbel" | "gumbel_lm"
    max_considered: int = 16       # gumbel: initial root candidate count
    c_puct: float = 1.5
    dirichlet_alpha: float = 0.5
    noise_frac: float = 0.25
    temp_moves: int = 8
    segment_len: int = 48
    # gumbel: each root's mixed value is the value target of plies of games
    # that do not finish inside the segment (instead of masking them out)
    bootstrap_unfinished: bool = True
    # optimization
    batch_size: int = 2048
    updates_per_iter: int = 8
    iterations: int = 32
    # model
    model: str = "conv"            # "conv" | "mlp"
    channels: int = 64
    blocks: int = 2
    hidden_sizes: tuple = (128, 128)


@dataclasses.dataclass
class AZState:
    """The net, its optimizer and the env batch; the iteration updates the
    net and optimizer in place and replaces ``env_state``."""

    net: torch.nn.Module
    optimizer: torch.optim.Optimizer
    env_state: bc.PlanesState


def make_net(config: AZConfig, device=None) -> torch.nn.Module:
    if config.model == "conv":
        return ac.ConvActorCritic(channels=config.channels, blocks=config.blocks, device=device)
    return ac.MLPActorCritic(hidden_sizes=tuple(config.hidden_sizes), device=device)


def mcts_config(config: AZConfig, selfplay: bool = True) -> mcts.MCTSConfig:
    return mcts.MCTSConfig(
        num_sims=config.num_sims,
        c_puct=config.c_puct,
        dirichlet_alpha=config.dirichlet_alpha if selfplay else 0.0,
        noise_frac=config.noise_frac if selfplay else 0.0,
    )


def _empty_traj(L: int, B: int, dev, gumbel_search: bool) -> dict:
    traj = {
        "obs": torch.empty((L, B, 117), dtype=torch.int8, device=dev),
        "mask": torch.empty((L, B, 54), dtype=torch.bool, device=dev),
        "pi": torch.empty((L, B, 54), dtype=torch.float32, device=dev),
        "player": torch.empty((L, B), dtype=torch.int32, device=dev),
        "done": torch.empty((L, B), dtype=torch.bool, device=dev),
        "winner": torch.empty((L, B), dtype=torch.int8, device=dev),
    }
    if gumbel_search:
        traj["v_signed"] = torch.empty((L, B), dtype=torch.float32, device=dev)
    return traj


def make_selfplay_segment(config: AZConfig):
    """``segment(net, env_state, generator) -> (env_state, traj)`` with
    ``traj`` a dict of ``[segment_len, B, ...]`` tensors: obs, mask, pi,
    player, done, winner (and v_signed for the Gumbel searches)."""
    if config.search in ("gumbel", "gumbel_lm"):
        return _make_gumbel_segment(config)
    mcfg = mcts_config(config, selfplay=True)

    @torch.no_grad()
    def segment(net, env_state, generator):
        L, B, dev = config.segment_len, env_state.current.shape[0], env_state.current.device
        traj = _empty_traj(L, B, dev, gumbel_search=False)
        state = env_state
        for t in range(L):
            visits, q, root_win = mcts_lm.mcts_search_lm(net, state.board, state.current,
                                                         generator, mcfg)
            mask = bc.legal_mask_planes(state.board, state.current).t()   # [B, 54]
            visits = torch.where(mask, visits, 0.0)
            pi = visits / visits.sum(-1, keepdim=True).clamp(min=1.0)
            # play: exact 1-ply wins dominate, else the visit argmax; the
            # first temp_moves plies of each game sample proportional to visits
            a_greedy = torch.where(mask, visits + 1e9 * root_win, -torch.inf).argmax(-1)
            logits_v = torch.where(visits > 0, torch.log(visits.clamp(min=1e-9)), -torch.inf)
            a_sample = (logits_v + bc.gumbel_field(generator, logits_v.shape, dev)).argmax(-1)
            actions = torch.where(state.turn < config.temp_moves, a_sample, a_greedy)
            traj["obs"][t] = _obs_bf(state.board, state.current)
            traj["mask"][t], traj["pi"][t], traj["player"][t] = mask, pi, state.current
            s1 = bc.step_trusted(state, actions)   # search actions are mask-legal
            traj["done"][t], traj["winner"][t] = s1.done, s1.winner
            state = bc.autoreset_planes(s1)
        return state, traj

    return segment


def _make_gumbel_segment(config: AZConfig):
    """Gumbel self-play: the root action carries its exploration through the
    Gumbel noise (no Dirichlet, no temperature schedule) and the policy
    target is the completed-Q improved policy.  ``segment`` takes an
    optional ``noise`` f32[segment_len, 54, B], one root field a ply, in
    place of the generator's draws."""
    gcfg = gumbel.GumbelConfig(num_sims=config.num_sims, max_considered=config.max_considered)

    @torch.no_grad()
    def segment(net, env_state, generator, noise=None):
        L, B, dev = config.segment_len, env_state.current.shape[0], env_state.current.device
        traj = _empty_traj(L, B, dev, gumbel_search=True)
        state = env_state
        for t in range(L):
            actions, pi, _, _, root_v = gumbel_lm.gumbel_search_lm(
                net, state.board, state.current, generator, gcfg,
                noise=None if noise is None else noise[t])
            traj["obs"][t] = _obs_bf(state.board, state.current)
            traj["mask"][t] = bc.legal_mask_planes(state.board, state.current).t()
            traj["pi"][t], traj["player"][t] = pi, state.current
            # mover-perspective root value -> absolute sign (+1 = player 0)
            traj["v_signed"][t] = root_v * torch.where(state.current == 0, 1.0, -1.0)
            s1 = bc.step_trusted(state, actions)   # search actions are mask-legal
            traj["done"][t], traj["winner"][t] = s1.done, s1.winner
            state = bc.autoreset_planes(s1)
        return state, traj

    return segment


def assign_outcomes(done, winner, player, bootstrap_signed=None):
    """Backfill per-ply value targets from episode outcomes, on the device.

    ``done`` bool[L, B], ``winner`` int8[L, B] (+1 = player 0 won),
    ``player`` int32[L, B] (the mover at that ply) -> (z float32[L, B] from
    the mover's perspective, valid bool[L, B]).

    Without ``bootstrap_signed``, plies of games that do not finish inside
    the segment are masked out (valid False).  With it (float32[L, B],
    absolute sign), the unfinished tail takes the last ply's estimate and
    every ply is valid."""
    L, B = done.shape
    if bootstrap_signed is None:
        w = torch.zeros(B, dtype=torch.float32, device=done.device)
        have = torch.zeros(B, dtype=torch.bool, device=done.device)
    else:
        w = bootstrap_signed[-1].to(torch.float32)
        have = torch.ones(B, dtype=torch.bool, device=done.device)
    z_signed = torch.empty((L, B), dtype=torch.float32, device=done.device)
    valid = torch.empty((L, B), dtype=torch.bool, device=done.device)
    for t in reversed(range(L)):
        w = torch.where(done[t], winner[t].to(torch.float32), w)
        have = have | done[t]
        z_signed[t], valid[t] = w, have
    return z_signed * torch.where(player == 0, 1.0, -1.0), valid


def make_loss_fn(config: AZConfig):
    """``loss_fn(net, batch) -> (loss, (policy_loss, value_loss))``; the
    batch carries obs/mask/pi/z/valid rows, invalid rows masked out of both
    terms."""

    def loss_fn(net, batch):
        logits, value = net(batch["obs"])
        logp = torch.log_softmax(torch.where(batch["mask"], logits, -1e9), dim=-1)
        p_loss = -(batch["pi"] * torch.where(batch["mask"], logp, 0.0)).sum(-1)
        v_loss = (torch.tanh(value) - batch["z"]) ** 2
        w = batch["valid"].to(torch.float32)
        denom = w.sum().clamp(min=1.0)
        p = (p_loss * w).sum() / denom
        v = (v_loss * w).sum() / denom
        return p + config.value_coef * v, (p, v)

    return loss_fn


def flatten_segment(traj, z, valid) -> dict:
    """[L, B, ...] self-play segment -> flat [L·B, ...] training rows."""
    n = z.numel()
    return {
        "obs": traj["obs"].reshape(n, -1),
        "mask": traj["mask"].reshape(n, -1),
        "pi": traj["pi"].reshape(n, -1),
        "z": z.reshape(n),
        "valid": valid.reshape(n),
    }


@torch.no_grad()
def clip_by_global_norm_(params, max_norm: float, sq_norm=None) -> None:
    """optax's ``clip_by_global_norm`` on the gradients, in place: each is
    scaled by ``max_norm / norm`` unless the global norm is below
    ``max_norm`` (no epsilon, unlike ``clip_grad_norm_``).  ``sq_norm``,
    if given, maps the gradients to the squared global norm (for
    parameters split over ranks, ``parallel/tensor_parallel.py``)."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum((g * g).sum() for g in grads) if sq_norm is None else sq_norm(grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def make_optimizer(config: AZConfig, net: torch.nn.Module) -> torch.optim.Optimizer:
    """AdamW with optax's defaults, the decay on every parameter (the
    gradient clip is applied by the update, before each step)."""
    return torch.optim.AdamW(net.parameters(), lr=config.lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=config.weight_decay)


def make_update_phase(config: AZConfig, grad_sync=None, grad_sq_norm=None):
    """Minibatched updates over a flat self-play batch:
    ``update_phase(net, optimizer, flat, generator, perm=None) ->
    (losses, policy_losses, value_losses)``, each float32[updates_per_iter].
    Update i trains on ``perm[start_i : start_i + mb]``; ``perm`` is a
    permutation of the rows drawn from ``generator`` unless given.

    ``grad_sync`` (``parallel.mesh.GradSync``), if given, averages the
    gradients over the data-parallel ranks after each backward pass and
    BEFORE the clip, as optax clips the averaged gradients; the losses
    returned stay this rank's.  ``grad_sq_norm`` is the clip's
    ``sq_norm``."""
    loss_fn = make_loss_fn(config)

    def update_phase(net, optimizer, flat, generator=None, perm=None):
        n = flat["z"].shape[0]
        mb = max(1, min(config.batch_size, n // max(config.updates_per_iter, 1)))
        if perm is None:
            perm = torch.randperm(n, generator=generator, device=flat["z"].device)
        out = []
        for i in range(config.updates_per_iter):
            start = (i * mb) % max(n - mb, 1)
            idx = perm[start:start + mb]
            loss, (p_l, v_l) = loss_fn(net, {k: v[idx] for k, v in flat.items()})
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            if grad_sync is not None:
                grad_sync(net.parameters())
            clip_by_global_norm_(net.parameters(), config.max_grad_norm, grad_sq_norm)
            optimizer.step()
            out.append(torch.stack([loss, p_l, v_l]).detach())
        return torch.stack(out).unbind(1)

    return update_phase


def make_train_iteration(config: AZConfig):
    """``train_iteration(st, generator, mark=None) -> stats`` (device
    scalars): one segment, the outcome backfill and the update phase, in
    place on ``st``.  ``mark``, if given, is called with "segment",
    "outcomes" and "updates" as each phase has been issued (a timer's
    hook)."""
    segment = make_selfplay_segment(config)
    update_phase = make_update_phase(config)

    def train_iteration(st: AZState, generator: torch.Generator, mark=None):
        mark = mark or (lambda phase: None)
        env_state, traj = segment(st.net, st.env_state, generator)
        mark("segment")
        bootstrap = traj.get("v_signed") if config.bootstrap_unfinished else None
        z, valid = assign_outcomes(traj["done"], traj["winner"], traj["player"], bootstrap)
        flat = flatten_segment(traj, z, valid)
        mark("outcomes")
        losses, p_ls, v_ls = update_phase(st.net, st.optimizer, flat, generator)
        mark("updates")
        st.env_state = env_state
        done, winner = traj["done"], traj["winner"]
        return {
            "loss": losses.mean(),
            "policy_loss": p_ls.mean(),
            "value_loss": v_ls.mean(),
            "episodes": done.sum(),
            "valid_frac": valid.to(torch.float32).mean(),
            "wins_p1": ((winner == 1) & done).sum(),
            "wins_p2": ((winner == -1) & done).sum(),
        }

    return train_iteration


def init_alphazero(config: AZConfig, generator: torch.Generator) -> AZState:
    """The net initialised from ``generator`` (on its device), its
    optimizer and a fresh env batch."""
    net = make_net(config, generator.device)
    net.reset_parameters(generator)
    return AZState(net=net, optimizer=make_optimizer(config, net),
                   env_state=bc.reset_planes(config.num_envs, generator.device))


def az_policy(net, num_sims: int = 128, c_puct: float = 1.5):
    """Tournament evaluation policy: noise-free lane-major PUCT on ``net``
    (see eval/tournament.py for the signature)."""
    return mcts_lm.mcts_lm_policy(net, mcts.MCTSConfig(num_sims=num_sims, c_puct=c_puct))


def train(config: AZConfig = AZConfig(), logger=None, checkpoint_dir: str | None = None,
          full_resume_dir: str | None = None, device=None):
    """Run AlphaZero self-play training; returns ``(AZState, history)``.

    ``checkpoint_dir`` saves the AZState after every iteration and, at
    start, restores the newest one: enough to continue training, not bit
    for bit.  ``full_resume_dir`` also saves the generator's state, so a run
    preempted and relaunched with the same config ends bit-identical to an
    uninterrupted one."""
    dev = resolve_device(device)
    generator = torch.Generator(device=dev)
    generator.manual_seed(config.seed)
    st = init_alphazero(config, generator)
    start = 0
    if checkpoint_dir is not None:
        step = ckpt.restore_az(checkpoint_dir, st)
        if step is not None:
            start = step + 1
    if full_resume_dir is not None:
        step = ckpt.restore_az(full_resume_dir, st, generator)
        if step is not None:
            start = step + 1

    train_iteration = make_train_iteration(config)
    history = []
    for i in range(start, config.iterations):
        stats = train_iteration(st, generator)
        record = {"iteration": i, **{k: v.item() for k, v in stats.items()}}
        history.append(record)
        if logger is not None:
            logger.log(record)
        if checkpoint_dir is not None:
            ckpt.save_az(checkpoint_dir, st, i)
        if full_resume_dir is not None:
            ckpt.save_az(full_resume_dir, st, i, generator)
    return st, history
