"""Learned-eval shallow search: a batched depth-1/2 minimax over the
lane-major engine with a trained value function at the leaves.

Port of ``gobblet_rl_tpu/policies/value_search.py``.  Every depth-2 leaf is
scored by a value net (a DQN's max legal Q, or the tanh of an actor-critic's
value head), and with ``solve_leaves`` the exact 1-ply solver certifies the
leaves where the mover wins at once, so three-ply forced wins are found
exactly while the rest is ranked by the learned value.

The tree of every env is laid out as folds of the lane axis: the 54
candidates of ``B`` envs are ``54·B`` lanes (lane ``a·B + b``), their
replies ``54·54·B`` lanes, and the leaf solve ``54³·B`` int8 engine lanes.
XLA fuses those folds; eager torch materialises each of them, about 150 B a
lane of the leaf solve (4.25 MB an env for its boards alone).  So the
candidates are taken in chunks that keep the leaf solve's fold under
:data:`FOLD_LANES` lanes and the leaf net evaluation under
:data:`NET_LANES`.  Candidates are independent, so the chunking changes no
result.

Scores sit on a fixed scale so that proven results dominate estimates:
+4 immediate win, +2 proven win in three (every reply leaves the mover a
1-ply win), [-1, 1] the learned leaf value, -2 the opponent has a winning
reply, -4 the candidate loses on the spot (it uncovers an opponent line).
"""

from __future__ import annotations

import torch

from gobblet_rl_torch import zoo
from gobblet_rl_torch.ops import batched_core as bc

A = 54  # action-space size

# Lane budgets of one chunk of candidates: the leaf solve's fold (int8
# engine lanes, ~150 B each while it is built) and the leaf net evaluation
# (a conv net's activations take a few KB a lane).
FOLD_LANES = 1 << 25
NET_LANES = 1 << 19


def _fold_actions(board: torch.Tensor, current: torch.Tensor, lo: int = 0,
                  hi: int = A) -> torch.Tensor:
    """Apply actions ``lo..hi-1`` to every lane by folding the action axis
    into the lane axis: board int8[3, 9, B], current int32[B] -> int8[3, 9,
    (hi-lo)·B] with lane ``(a-lo)·B + b`` = action ``a`` on env ``b``.
    Illegal actions are applied unchecked: callers mask by legality."""
    B = current.shape[0]
    n = hi - lo
    boards_t = board[:, :, None, :].expand(3, 9, n, B).reshape(3, 9, n * B)
    cur_t = current[None].expand(n, B).reshape(n * B)
    act_t = torch.arange(lo, hi, dtype=torch.int32, device=board.device)
    act_t = act_t[:, None].expand(n, B).reshape(n * B)
    return bc.apply_action_unchecked(boards_t, cur_t, act_t)


def _can_win_now(board: torch.Tensor, current: torch.Tensor) -> torch.Tensor:
    """bool[B]: the mover has a legal immediate win (exact 1-ply solve over
    engine lanes, no net evaluation)."""
    B = current.shape[0]
    mask = bc.legal_mask_planes(board, current)                  # [54, B]
    stepped = _fold_actions(board, current)                      # [3, 9, 54·B]
    w = bc.winner_planes(bc.flat_planes(stepped)).view(A, B)
    sign = bc.player_sign_planes(current)
    return (mask & (w == sign[None])).any(dim=0)


def candidate_chunk(batch: int, depth: int, solve_leaves: bool) -> int:
    """Candidates per chunk at ``batch`` envs: as many as keep the leaf
    solve's fold under :data:`FOLD_LANES` and the leaf net evaluation under
    :data:`NET_LANES` lanes, at least one, at most 54."""
    net = batch * (A if depth == 2 else 1)
    fold = net * (A if depth == 2 and solve_leaves else 1)
    return max(1, min(A, FOLD_LANES // fold, NET_LANES // net))


@torch.no_grad()
def search_scores(value_fn, board: torch.Tensor, current: torch.Tensor, depth: int = 2,
                  solve_leaves: bool = True) -> torch.Tensor:
    """float32[54, B]: every candidate's score on the fixed scale, -inf for
    an illegal candidate, before the tie noise (see
    :func:`make_value_search`)."""
    assert depth in (1, 2), depth
    B = current.shape[0]
    dev = board.device
    sign = bc.player_sign_planes(current)                        # int8[B]
    w1 = torch.empty((A, B), dtype=torch.int8, device=dev)
    score = torch.empty((A, B), dtype=torch.float32, device=dev)
    chunk = candidate_chunk(B, depth, solve_leaves)
    for lo in range(0, A, chunk):
        hi = min(A, lo + chunk)
        n = hi - lo
        boards1 = _fold_actions(board, current, lo, hi)         # [3, 9, n·B]
        w1[lo:hi] = bc.winner_planes(bc.flat_planes(boards1)).view(n, B)
        them = (1 - current).repeat(n)                           # lane (a-lo)·B + b
        if depth == 1:
            v_opp = value_fn(boards1, them)
            score[lo:hi] = -v_opp.clamp(-1.0, 1.0).view(n, B)
            continue
        # every reply on every candidate board: reply-major rows over
        # candidate-folded lanes
        mask2 = bc.legal_mask_planes(boards1, them)              # [54, n·B]
        boards2 = _fold_actions(boards1, them)                   # [3, 9, 54·n·B]
        del boards1
        w2 = bc.winner_planes(bc.flat_planes(boards2)).view(A, n * B)
        opp_wins = mask2 & (w2 == -sign.repeat(n)[None])
        del w2
        us2 = current.repeat(A * n)
        leaf_v = value_fn(boards2, us2).clamp(-1.0, 1.0).view(A, n * B)
        if solve_leaves:
            can_win = _can_win_now(boards2, us2).view(A, n * B)
            leaf_v = torch.where(can_win, 2.0, leaf_v)
        del boards2, us2
        reply_sc = torch.where(opp_wins, -2.0, leaf_v)
        reply_sc = torch.where(mask2, reply_sc, torch.inf)
        # no legal reply cannot happen on a live board; the clip keeps the
        # score finite
        score[lo:hi] = reply_sc.amin(dim=0).clamp(-4.0, 3.0).view(n, B)

    score = torch.where(w1 == sign[None], 4.0, score)
    # a candidate that uncovers an opponent line loses on the spot
    score = torch.where(w1 == -sign[None], -4.0, score)
    return torch.where(bc.legal_mask_planes(board, current), score, -torch.inf)


def make_value_search(value_fn, depth: int = 2, solve_leaves: bool = True,
                      tie_noise: float = 1e-5):
    """A tournament policy ``(generator, board int8[3, 9, B], current
    int32[B], gumbel=None) -> int32[B]`` (``eval/tournament.py``'s
    ``PolicyFn``).

    ``value_fn(board[3, 9, N], current[N]) -> float32[N]`` scores a position
    from the mover's perspective in about [-1, 1] (clipped here); see
    :func:`dqn_value_fn` and :func:`az_value_fn`.

    ``depth=1``: the argmax of -value(the opponent's node) after our move.
    ``depth=2``: the full candidate x reply minimax with the learned value
    at the 2-ply leaves; ``solve_leaves`` also certifies the leaves where we
    win at once (three-ply forced wins become exact).

    Ties break by a Gumbel field times ``tie_noise``, like the reference's
    random fallback: ``gumbel`` is an optional pre-drawn float32 [54, B]
    field; without it the noise comes from ``generator``."""
    assert depth in (1, 2), depth

    @torch.no_grad()
    def policy(generator, board, current, gumbel=None):
        score = search_scores(value_fn, board, current, depth, solve_leaves)
        if gumbel is None:
            if generator is None:
                raise ValueError("the value search needs a generator or a gumbel field")
            gumbel = bc.gumbel_field(generator, score.shape, board.device)
        # -inf stays -inf: JAX's where(mask, score + g, -inf), bit for bit
        return (score + tie_noise * gumbel).argmax(dim=0).to(torch.int32)

    return policy


def dqn_value_fn(net):
    """Position value = the max legal Q of a ``QNet``.  Observations are
    mover-perspective, so one head scores both seats."""

    @torch.no_grad()
    def value(board, current):
        q = net(bc.features_lm(board, current).t())
        mask = bc.legal_mask_planes(board, current).t()
        return torch.where(mask, q, -torch.inf).amax(dim=-1)

    return value


def az_value_fn(net):
    """The tanh of an actor-critic's value head (mover-perspective) as a
    leaf evaluator: search without MCTS."""

    @torch.no_grad()
    def value(board, current):
        _, v = net(bc.features_lm(board, current).t())
        return torch.tanh(v)

    return value


def zoo_search_policy(name: str, depth: int = 2, solve_leaves: bool = True, device=None):
    """Depth-``depth`` learned-eval search over a zoo entry's value head
    (dqn: max Q; alphazero and ppo: the critic), loaded on ``device``
    (``None``: the CUDA card, or raise).  The ``<name>+search2`` entrants
    of ``examples/example_tournament.py`` are built here."""
    net, _, entry = zoo.load(name, device=device)
    vf = dqn_value_fn(net) if entry["family"] == "dqn" else az_value_fn(net)
    return make_value_search(vf, depth=depth, solve_leaves=solve_leaves)
