"""Actor-learner DQN with the opponent in the loop, on the card.

Port of ``gobblet_rl_tpu/train/dqn.py``.  One training iteration is:
collect ``segment_len + n_step - 1`` learner transitions over the whole env
batch (learner ply, opponent reply, auto-reset) -> fold and insert them
into the replay ring -> one uniform sample for all ``update_per_collect``
minibatches -> that many double-DQN updates (MSE TD loss, Adam, target
sync every ``target_update_freq`` gradient steps).

The opponent is "random", "greedy" (the batched depth-1/2 lookahead of
``policies/greedy_jax.py``), "self" (a frozen copy of the learner) or
"mixed" (one of the three drawn per iteration).  With ``defense_bc_weight
> 0`` every update adds the cross-entropy of the masked Q-values to the
solver's labels over the whole defense bank (``train/defense.py``).

The networks are :class:`QNet` modules held in a mutable
:class:`TrainState`; updates change them in place.  All device randomness
comes from one explicit ``torch.Generator`` on the training device; the
mixed opponent's draws come from a numpy generator seeded with
``config.seed``, the same call as the JAX trainer's.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from gobblet_rl_torch.device import resolve_device
from gobblet_rl_torch.kernels import draw
from gobblet_rl_torch.models.mlp import QNet, masked_argmax, masked_q
from gobblet_rl_torch.ops import batched_core as bc
from gobblet_rl_torch.policies import greedy_jax
from gobblet_rl_torch.train import checkpoint as ckpt
from gobblet_rl_torch.train import defense, replay
from gobblet_rl_torch.utils import profiling

MIXED_KINDS = ("random", "greedy", "self")  # the order of mixed_weights


@dataclasses.dataclass(frozen=True)
class DQNConfig:
    """Same fields and defaults as the JAX package's ``DQNConfig``."""

    seed: int = 42
    eps_train: float = 0.1
    eps_test: float = 0.05
    buffer_size: int = 1 << 18
    lr: float = 1e-4
    gamma: float = 0.9
    n_step: int = 3
    target_update_freq: int = 320
    epoch: int = 10
    step_per_epoch: int = 64          # collect iterations per epoch
    segment_len: int = 16             # learner steps per collect iteration
    update_per_collect: int = 8       # gradient steps per collect iteration
    batch_size: int = 1024
    hidden_sizes: tuple = (128, 128, 128, 128)
    double: bool = True               # double-DQN target
    dueling: bool = True              # dueling value/advantage head
    eps_eval: float = 0.0             # evaluation epsilon
    num_envs: int = 1024
    # 0 / 1 pin the learner to one seat; "both" alternates seats per env
    learner_player: int | str = 0
    opponent: str = "random"          # "random" | "greedy" | "self" | "mixed"
    greedy_depth: int = 2
    mixed_weights: tuple = (0.25, 0.25, 0.5)
    defense_bc_weight: float = 0.0
    defense_bank_games: int = 256
    defense_bank_depth: int = 16


@dataclasses.dataclass
class TrainState:
    """Learner, target and opponent nets, the optimizer over the learner's
    parameters and the gradient-step count.  Mutated in place by
    :func:`update`."""

    net: QNet
    target_net: QNet
    opponent_net: QNet     # used when opponent == "self"
    optimizer: torch.optim.Optimizer
    grad_steps: int = 0


def _obs_bf(board, current):
    """Batch-first flattened observation for the Q-net: int8[B, 117]."""
    return bc.features_lm(board, current).t()


def _sel(pred, a, b):
    """Select lane-major leaves by a [B] predicate."""
    return torch.where(pred.reshape((1,) * (a.dim() - 1) + (-1,)), a, b)


def make_opponent_fn(config: DQNConfig):
    """(generator, board, current, opponent_net) -> int32[B] actions, each
    call inside the span ``dqn.opponent``."""
    if config.opponent == "random":

        def fn(generator, board, current, opp_net):
            return draw.random_legal_actions(board, current, generator)

    elif config.opponent == "greedy":

        def fn(generator, board, current, opp_net):
            return greedy_jax.greedy_actions(generator, board, current, config.greedy_depth)

    elif config.opponent == "self":

        @torch.no_grad()
        def fn(generator, board, current, opp_net):
            mask = bc.legal_mask_planes(board, current).t()
            return masked_argmax(opp_net(_obs_bf(board, current)), mask)

    else:
        raise ValueError(f"unknown opponent {config.opponent!r}")

    def opponent(generator, board, current, opp_net):
        with profiling.annotate("dqn.opponent"):
            return fn(generator, board, current, opp_net)

    return opponent


def _eps_greedy(generator, q, mask_bf, board, current, eps):
    """Masked epsilon-greedy: the masked argmax, replaced with probability
    ``eps`` by a uniform legal action of the position (``board``,
    ``current``) that ``mask_bf`` masks."""
    greedy = masked_argmax(q, mask_bf)
    rand = draw.random_legal_actions(board, current, generator)
    explore = torch.rand(q.shape[0], generator=generator, device=q.device) < eps
    return torch.where(explore, rand, greedy)


def seat_array(learner_player, batch: int, device) -> torch.Tensor:
    """int32[B] learner seat per env: constant for a pinned seat,
    alternating even/odd envs for ``"both"``."""
    if learner_player == "both":
        return torch.arange(batch, dtype=torch.int32, device=device) % 2
    return torch.full((batch,), learner_player, dtype=torch.int32, device=device)


def _seat_reward(rewards, seat):
    """float32[B]: each env's reward from its learner seat's perspective."""
    return torch.where(seat == 0, rewards[0], rewards[1])


def make_learner_step(config: DQNConfig, opponent_fn):
    """One learner transition: learner ply + opponent reply + auto-reset,
    keeping every env at its learner seat's turn.  Every action is derived
    from the legal mask, so the steps are the trusted (unchecked) kind.

    Traced, a step is the span ``dqn.engine``; each opponent call adds B
    to the counter ``dqn.opponent_rows`` and the rows its move changes to
    ``dqn.opponent_rows_played``."""
    lp = config.learner_player

    def learner_step(state, actions, generator, opp_net):
        with profiling.annotate("dqn.engine"):
            B = state.current.shape[0]
            seat = seat_array(lp, B, state.current.device)
            s1 = bc.step_trusted(state, actions)
            r = _seat_reward(s1.rewards, seat)
            a_opp = opponent_fn(generator, s1.board, s1.current, opp_net)
            if profiling.enabled():
                profiling.count("dqn.opponent_rows", B)
                profiling.count("dqn.opponent_rows_played", (~s1.done).sum())
            s2 = bc.step_trusted(s1, a_opp)  # frozen no-op where s1.done
            r = r + _seat_reward(s2.rewards, seat)
            done = s2.done
            s3 = bc.autoreset_planes(s2)
            if lp != 0:
                # after a reset player 0 opens; envs whose learner seat is 1
                # need the opponent to move first
                need = s3.current != seat
                a0 = opponent_fn(generator, s3.board, s3.current, opp_net)
                if profiling.enabled():
                    profiling.count("dqn.opponent_rows", B)
                    profiling.count("dqn.opponent_rows_played", need.sum())
                s4 = bc.step_trusted(s3, a0)
                s3 = bc.PlanesState(*(_sel(need, x4, x3) for x4, x3 in zip(s4, s3)))
            return s3, r, done

    return learner_step


def init_env_state(config: DQNConfig, opponent_fn, opp_net, generator: torch.Generator):
    """Fresh env batch on the generator's device, with the opponent's
    opening move where the learner sits second."""
    state = bc.reset_planes(config.num_envs, generator.device)
    if config.learner_player != 0:
        seat = seat_array(config.learner_player, config.num_envs, generator.device)
        need = state.current != seat
        a0 = opponent_fn(generator, state.board, state.current, opp_net)
        stepped = bc.step_planes(state, a0)
        state = bc.PlanesState(*(_sel(need, x1, x0) for x1, x0 in zip(stepped, state)))
    return state


def update(config: DQNConfig, ts: TrainState, batch, bank: dict | None = None,
           grad_sync=None) -> torch.Tensor:
    """One double-DQN gradient step on ``batch`` = (obs, action, reward_n,
    done_n, obs_n, mask_n), in place on ``ts``; returns the detached loss.
    With a defense ``bank``, the loss adds ``defense_bc_weight`` times the
    bank's cross-entropy over the masked Q-values as logits.  ``grad_sync``
    (``parallel.mesh.GradSync``), if given, averages the gradients and the
    loss over the data-parallel ranks before the optimizer steps.

    Traced, the step is the span ``dqn.update`` around
    ``dqn.update.forward`` (the target and the loss),
    ``dqn.update.backward`` (with the gradient sync) and
    ``dqn.update.step`` (Adam and the target sync)."""
    obs, action, reward_n, done_n, obs_n, mask_n = batch
    with profiling.annotate("dqn.update"):
        with profiling.annotate("dqn.update.forward"):
            with torch.no_grad():
                q_next = masked_q(ts.target_net(obs_n), mask_n)
                if config.double:
                    # online net picks the action, target net rates it
                    a_star = masked_q(ts.net(obs_n), mask_n).argmax(dim=-1)
                    q_star = q_next.gather(-1, a_star[:, None])[:, 0]
                else:
                    q_star = q_next.max(dim=-1).values
                target = reward_n + (config.gamma ** config.n_step) * (~done_n) * q_star
            q = ts.net(obs)
            q_a = q.gather(-1, action.long()[:, None])[:, 0]
            loss = ((q_a - target) ** 2).mean()
            if bank is not None:
                loss = loss + config.defense_bc_weight * defense.bank_loss(
                    ts.net(bank["obs"]), bank)
        with profiling.annotate("dqn.update.backward"):
            ts.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            if grad_sync is not None:
                (loss,) = grad_sync(ts.net.parameters(), loss)
        with profiling.annotate("dqn.update.step"):
            ts.optimizer.step()
            ts.grad_steps += 1
            if ts.grad_steps % config.target_update_freq == 0:
                ts.target_net.load_state_dict(ts.net.state_dict())
        return loss.detach()


def make_train_iteration(config: DQNConfig, bank: dict | None = None, grad_sync=None):
    """Returns ``(train_iteration, opponent_fn)`` (updates with the defense
    ``bank``, if given, and ``grad_sync``, as :func:`update`);
    ``train_iteration(ts, env_state, buffer, generator, mark=None)`` returns
    ``(env_state, buffer, mean loss)`` and updates ``ts`` and the ring in
    place.  ``mark``, if given, is called with "collect", "insert",
    "sample" and "updates" as each phase has been issued (a timer's
    hook).

    Traced, an iteration is the root span ``dqn.iteration``; each phase
    is a span of its name (``dqn.collect``, ...) that ends where its
    ``mark`` is called, and each ply of collect holds a ``dqn.actor``
    (mask, features, forward, eps-greedy draw) and a ``dqn.engine``
    (:func:`make_learner_step`); the snapshot stores stay in collect's
    own time."""
    opponent_fn = make_opponent_fn(config)
    learner_step = make_learner_step(config, opponent_fn)
    L = config.segment_len + config.n_step - 1  # tail for a full n-step horizon

    @torch.no_grad()
    def collect(ts: TrainState, env_state, generator):
        B = env_state.current.shape[0]
        dev = env_state.current.device
        # only raw state snapshots are kept; the ring derives features
        boards = torch.empty((L + 1, 3, 9, B), dtype=torch.int8, device=dev)
        currents = torch.empty((L + 1, B), dtype=torch.int32, device=dev)
        actions = torch.empty((L, B), dtype=torch.int32, device=dev)
        rewards = torch.empty((L, B), dtype=torch.float32, device=dev)
        dones = torch.empty((L, B), dtype=torch.bool, device=dev)
        for t in range(L):
            boards[t], currents[t] = env_state.board, env_state.current
            with profiling.annotate("dqn.actor"):
                mask = bc.legal_mask_planes(env_state.board, env_state.current).t()
                q = ts.net(_obs_bf(env_state.board, env_state.current))
                actions[t] = _eps_greedy(generator, q, mask, env_state.board,
                                         env_state.current, config.eps_train)
            env_state, rewards[t], dones[t] = learner_step(
                env_state, actions[t], generator, ts.opponent_net
            )
        boards[L], currents[L] = env_state.board, env_state.current
        return env_state, replay.StateSegment(boards, currents, actions, rewards, dones)

    def train_iteration(ts: TrainState, env_state, buffer, generator, mark=None):
        mark = mark or (lambda phase: None)
        with profiling.annotate("dqn.iteration"):
            with profiling.annotate("dqn.collect"):
                env_state, sseg = collect(ts, env_state, generator)
            mark("collect")
            with profiling.annotate("dqn.insert"):
                buffer = replay.insert_segment(buffer, sseg, config.n_step, config.gamma,
                                               config.segment_len)
            mark("insert")
            # one gather for ALL minibatches: the ring is fixed during the
            # update phase, so this is distribution-identical to per-update draws
            U, bs = config.update_per_collect, config.batch_size
            with profiling.annotate("dqn.sample"):
                flat = replay.sample(buffer, generator, bs * U)
            mark("sample")
            with profiling.annotate("dqn.updates"):
                losses = [update(config, ts, tuple(x[u * bs:(u + 1) * bs] for x in flat), bank,
                                 grad_sync) for u in range(U)]
            mark("updates")
            return env_state, buffer, torch.stack(losses).mean()

    return train_iteration, opponent_fn


def make_net(config: DQNConfig, device=None) -> QNet:
    return QNet(hidden_sizes=tuple(config.hidden_sizes), dueling=config.dueling,
                device=device)


def init_train_state(config: DQNConfig, net: QNet, generator: torch.Generator) -> TrainState:
    """Initialise ``net`` from ``generator``; target and opponent start as
    copies of it."""
    net.reset_parameters(generator)
    return TrainState(
        net=net,
        target_net=copy.deepcopy(net),
        opponent_net=copy.deepcopy(net),
        optimizer=torch.optim.Adam(net.parameters(), lr=config.lr, betas=(0.9, 0.999),
                                   eps=1e-8),
    )


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------
def make_eval_fn(config: DQNConfig, opponent_fn):
    """Win/loss/other counts of the eps_eval-greedy learner vs the
    opponent."""

    @torch.no_grad()
    def evaluate(net, opp_net, generator, num_steps: int = 64, num_envs: int = 512):
        dev = generator.device
        state = bc.reset_planes(num_envs, dev)
        seat = seat_array(config.learner_player, num_envs, dev)
        lsign = torch.where(seat == 0, 1, -1).to(torch.int8)
        counts = torch.zeros(3, dtype=torch.int64, device=dev)
        for _ in range(num_steps):
            mask = bc.legal_mask_planes(state.board, state.current)
            q = net(_obs_bf(state.board, state.current))
            a_learn = _eps_greedy(generator, q, mask.t(), state.board, state.current,
                                  config.eps_eval)
            a_opp = opponent_fn(generator, state.board, state.current, opp_net)
            stepped = bc.step_trusted(state, torch.where(state.current == seat, a_learn, a_opp))
            counts += torch.stack([
                (stepped.winner == lsign).sum(),
                (stepped.winner == -lsign).sum(),
                (stepped.done & (stepped.winner == 0)).sum(),
            ])
            state = bc.autoreset_planes(stepped)
        w, l, other = counts.tolist()
        return w, l, other

    return evaluate


# ---------------------------------------------------------------------------
# Host training loop
# ---------------------------------------------------------------------------
def train(config: DQNConfig = DQNConfig(), logger=None, generations: int = 1,
          checkpoint_dir: str | None = None, full_resume_dir: str | None = None,
          device=None):
    """Train a masked DQN; returns (final TrainState, history list).

    ``generations > 1`` runs the self-play loop: the opponent net takes a
    snapshot of the learner after each generation.

    ``checkpoint_dir`` saves the train state after every epoch.
    ``full_resume_dir`` saves a complete resume point after every epoch
    (:func:`~gobblet_rl_torch.train.checkpoint.save_full`, with the epoch
    counter as its step and the mixed opponent's numpy generator in its
    meta sidecar) and, at start, restores the newest one: a run preempted
    and relaunched with the same arguments continues the schedule where it
    stopped and ends bit-identical to an uninterrupted run."""
    dev = resolve_device(device)
    generator = torch.Generator(device=dev)
    generator.manual_seed(config.seed)
    ts = init_train_state(config, make_net(config, dev), generator)
    rng_mix = np.random.default_rng(config.seed)
    bank = None
    if config.defense_bc_weight > 0:
        bank = defense.bank_tensors(defense.generate_defense_bank(
            num_games=config.defense_bank_games, seed=config.seed,
            depth=config.defense_bank_depth, device=dev), dev)
    if config.opponent == "mixed":
        variants = {kind: make_train_iteration(dataclasses.replace(config, opponent=kind), bank)
                    for kind in MIXED_KINDS}

        def pick_iteration():
            return variants[rng_mix.choice(MIXED_KINDS, p=list(config.mixed_weights))][0]

        # evaluation and the env bootstrap use the greedy opponent
        train_iteration, opponent_fn = variants["greedy"]
    else:
        train_iteration, opponent_fn = make_train_iteration(config, bank)

        def pick_iteration():
            return train_iteration

    evaluate = make_eval_fn(config, opponent_fn)
    env_state = init_env_state(config, opponent_fn, ts.opponent_net, generator)
    buffer = replay.make_buffer(config.buffer_size, dev)

    start = 0  # flat epoch counter: e = generation * config.epoch + epoch
    if full_resume_dir is not None:
        payload, step = ckpt.restore_full(full_resume_dir, ts, generator)
        if payload is not None:
            meta = ckpt.load_meta(full_resume_dir, step)
            if meta is None:
                raise RuntimeError(
                    f"checkpoint step {step} in {full_resume_dir!r} has no "
                    f"meta-{step}.json sidecar; cannot resume bit-exactly")
            env_state = bc.PlanesState(**payload["env_state"])
            buffer = replay.ReplayBuffer(**payload["buffer"])
            rng_mix.bit_generator.state = meta["rng_mix_state"]
            start = step + 1

    history = []
    for e in range(start, generations * config.epoch):
        gen, epoch = divmod(e, config.epoch)
        losses = []
        for _ in range(config.step_per_epoch):
            env_state, buffer, loss = pick_iteration()(ts, env_state, buffer, generator)
            losses.append(loss)  # device scalar; synced once per epoch
        losses = torch.stack(losses).tolist()
        w, l, other = evaluate(ts.net, ts.opponent_net, generator)
        record = {
            "generation": gen,
            "epoch": epoch,
            "loss": sum(losses) / len(losses),
            "win_rate": w / max(w + l + other, 1),
            "wins": w,
            "losses_games": l,
            "other": other,
            "grad_steps": ts.grad_steps,
        }
        history.append(record)
        if logger is not None:
            logger.log(record)
        # self-play generation hand-off, BEFORE the resume point is written:
        # a relaunch after a generation's last epoch sees the new opponent
        if epoch == config.epoch - 1:
            ts.opponent_net.load_state_dict(ts.net.state_dict())
        if checkpoint_dir is not None:
            ckpt.save(checkpoint_dir, ts, step=ts.grad_steps)
        if full_resume_dir is not None:
            ckpt.save_full(full_resume_dir, ts, env_state, buffer, generator, step=e,
                           meta={"rng_mix_state": rng_mix.bit_generator.state})
    return ts, history
