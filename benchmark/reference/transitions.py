"""Judge the rows a DQN iteration wrote into its replay ring.

A ring row is ``(board, current, action, reward_n, done_n, board_n,
current_n)``: the state the learner saw, its move, the folded n-step
reward and end flag, and the state ``n`` learner turns later.  Row
``t * B + b`` of an iteration is env ``b`` at learner turn ``t``, so the
rows of one env give its states at turns ``0 .. S + n - 1``, and its
moves at turns ``0 .. S - 1``.

For the sampled envs the reference checks, from the rules alone:

* every state is at the learner's turn, and the two copies of a state
  (as ``board`` of row ``t`` and ``board_n`` of row ``t - n``) agree;
* each learner move is legal;
* after it, either the learner won and the env restarted, or the
  opponent replied with a move its rule allows (``opponents.allowed``)
  and, if that reply ended the game, the env restarted; a restart puts
  the env back on an empty board, with the opponent's allowed opening
  where the learner moves second;
* the n-step fold: ``done_n`` is whether the game ended within ``n``
  turns, and ``reward_n`` the discounted end reward from the learner's
  side.

On the last ``n - 1`` turns of a segment the ring keeps no learner move,
so there the reference checks whether the env restarted, and takes the
sign of the end reward from the ring.
"""

from __future__ import annotations

import torch

from benchmark.reference import opponents, rules


def is_reset(board, current, seat):
    """bool[N]: the state right after a restart for a learner in ``seat``:
    an empty board with player 0 to move, or player 0's one opening piece
    with player 1 to move."""
    count = rules.pieces_on_board(board)
    p0 = (board > 0).flatten(1).sum(1)
    return torch.where(seat == 0, (count == 0) & (current == 0),
                       (count == 1) & (p0 == 1) & (current == 1))


def _valid_opening(board, kind, depth):
    """bool[N]: ``board`` is an empty board plus one opening move that the
    opponent (player 0) may play."""
    n = board.shape[0]
    empty = torch.zeros_like(board)
    zero = torch.zeros(n, dtype=torch.int32, device=board.device)
    allow = opponents.allowed(kind, empty, zero, depth)
    after = rules.apply_all(empty, zero)
    match = (after == board[:, None]).flatten(2).all(2)
    return (allow & match).any(1)


def check_iteration(rows: dict, seats: torch.Tensor, kind: str, depth: int, n_step: int,
                    gamma: float):
    """Faults of one iteration's rows for the sampled envs.  ``rows`` holds
    ``[S, E, ...]`` tensors; ``seats`` int32[E] the learner seat of each.
    Returns ``(faults, first_board, last_board, first_current,
    last_current)``: a dict of fault counts and the env states at turns 0
    and ``S + n - 1`` (for the check across iterations)."""
    S, E = rows["action"].shape
    dev = rows["action"].device
    board = rows["board"].view(S, E, 3, 9)
    board_n = rows["board_n"].view(S, E, 3, 9)
    cur = rows["current"].to(torch.int32)
    cur_n = rows["current_n"].to(torch.int32)
    T = S + n_step
    states = torch.cat([board, board_n[S - n_step:]])          # turns 0 .. S + n - 1
    currents = torch.cat([cur, cur_n[S - n_step:]])
    faults = {}
    faults["copies_differ"] = int(((board[n_step:] != board_n[:S - n_step]).flatten(2).any(2)
                                   | (cur[n_step:] != cur_n[:S - n_step])).sum())
    faults["not_learner_turn"] = int((currents != seats[None]).sum())

    # turns 0 .. S - 1, where the learner's move is known
    s_t = states[:S].reshape(S * E, 3, 9)
    s_next = states[1:S + 1].reshape(S * E, 3, 9)
    c_next = currents[1:S + 1].reshape(S * E)
    seat = seats.repeat(S)
    ssign = rules.sign(seat).to(torch.float32)
    a = rows["action"].reshape(S * E).long()
    legal = rules.legal_mask(s_t, seat).gather(1, a[:, None])[:, 0]
    faults["illegal_learner_move"] = int((~legal).sum())
    s1 = rules.apply(s_t, seat, a)
    w1 = rules.winner(s1)
    restart = is_reset(s_next, c_next, seat)
    learner_end = w1 != 0
    faults["win_without_restart"] = int((learner_end & ~restart).sum())

    reward = torch.where(learner_end, w1.to(torch.float32) * ssign, 0.0)
    ring_r = rows["reward_n"].reshape(S * E)
    ok_reply = torch.ones(S * E, dtype=torch.bool, device=dev)
    idx = torch.nonzero(~learner_end)[:, 0]
    if idx.numel():
        opp = 1 - seat[idx]
        b1 = s1[idx]
        allow = opponents.allowed(kind, b1, opp, depth)
        after = rules.apply_all(b1, opp)
        w2 = rules.winner(after.flatten(0, 1)).view(-1, rules.NUM_ACTIONS)
        side = ssign[idx][:, None]
        ended = restart[idx]
        # the game went on: the reply that leads to the next state is allowed and ends nothing
        match = (after == s_next[idx][:, None]).flatten(2).all(2)
        cont_ok = (match & allow & (w2 == 0)).any(1)
        # the reply ended the game: an allowed reply gives the end reward the ring holds
        r_sign = torch.sign(ring_r[idx])[:, None]
        end_ok = (allow & (w2 != 0) & (w2.to(torch.float32) * side == r_sign)).any(1)
        ok_reply[idx] = torch.where(ended, end_ok, cont_ok)
        reward[idx] = torch.where(ended, r_sign[:, 0], 0.0)
    faults["reply_not_allowed"] = int((~ok_reply).sum())

    # a restart where the learner sits second includes the opponent's opening
    done = restart.view(S, E)
    second = restart & (seat == 1)
    opening_ok = torch.ones(S * E, dtype=torch.bool, device=dev)
    if second.any():
        opening_ok[second] = _valid_opening(s_next[second], kind, depth)
    faults["opening_not_allowed"] = int((~opening_ok).sum())

    # the tail turns S .. S + n - 2: only whether the env restarted
    tail_seat = seats.repeat(n_step - 1)
    tail_done = is_reset(states[S + 1:T].reshape(-1, 3, 9),
                         currents[S + 1:T].reshape(-1), tail_seat).view(n_step - 1, E)
    done_all = torch.cat([done, tail_done])                   # turns 0 .. S + n - 2
    reward_all = torch.cat([reward.view(S, E), torch.full((n_step - 1, E), torch.nan,
                                                          device=dev)])
    faults["fold"] = _fold_faults(rows, done_all, reward_all, n_step, gamma)
    return faults, states[0], states[T - 1], currents[0], currents[T - 1]


def _fold_faults(rows, done_all, reward_all, n_step, gamma):
    """Rows whose ``done_n`` / ``reward_n`` differ from the fold of the
    per-turn ends and rewards (a NaN reward: sign taken from the ring)."""
    S = rows["action"].shape[0]
    exp_r = torch.zeros_like(rows["reward_n"])
    found = torch.zeros_like(rows["done_n"])
    for k in range(n_step):
        d_k = done_all[k:S + k]
        first = d_k & ~found
        r_k = reward_all[k:S + k]
        r_k = torch.where(torch.isnan(r_k), torch.sign(rows["reward_n"]), r_k)
        exp_r = torch.where(first, (gamma ** k) * r_k, exp_r)
        found |= d_k
    bad = (found != rows["done_n"]) | ((exp_r - rows["reward_n"]).abs() > 1e-6)
    return int(bad.sum())


def check_start(board, current, seats, kind, depth):
    """Faults of the first iteration's starting states: each env restarted
    as its learner seat says."""
    ok = is_reset(board, current.to(torch.int32), seats)
    second = seats == 1
    if second.any():
        ok[second] &= _valid_opening(board[second], kind, depth)
    return int((~ok).sum())
