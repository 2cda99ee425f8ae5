"""Lane-major (batch-last) Gumbel MCTS: the whole batch of trees as tensor
code.

Port of ``gobblet_rl_tpu/search/gumbel_lm.py``: the same algorithm as
:mod:`gobblet_rl_torch.search.gumbel` (sequential halving at the root,
improved-policy interior selection, the mixed-value estimator, exact 1-ply
certification), with the env batch on the trailing axis of every tree
array (``N/W/P: f32[M, 54, B]``, ``boards: int8[M, 3, 9, B]``,
``M = num_sims + 1``).

Per-lane tree operations.  The JAX module selects a node's row with a
one-hot mask over the node axis and a sum (``_oh_m``, ``_row``,
``_scal``, ``_board_at``) and backs up with one-hot accumulates, which
streams the whole ``[M, 54, B]`` array on the TPU's vector unit.  Here a
row select is one ``gather`` along the node axis (:func:`_row`,
:func:`_scal`, :func:`_board_at`, for any dtype, so the bool variants are
the same functions) and a backup or child-pointer write is one
read-modify-write at ``(node, action, lane)`` by advanced indexing: the
same values (a one-hot sum adds one element to zeros), reading and writing
one element a lane instead of all M rows.

Loops.  The descent and the backup are ``while_loop``s on ``live.any()``
in JAX.  At simulation ``s`` the tree holds at most ``s + 1`` nodes, so the
descent takes at most ``min(s, 40)`` steps and the backup at most one
more; a lane that has stopped stays frozen.  Both loops here run to that
bound and stop as soon as no lane is live, one host sync a step, which
gives the JAX loop's result bit for bit.

Tracing (``utils/profiling.py``, off unless ``torch.profiler`` records):
``az.search`` ⊃ ``az.root``, ``az.descend``, ``az.expand`` (⊃ ``az.net``,
every net evaluation, and ``az.wins``, every one-move win check) and
``az.backup``; the root's evaluation is an ``az.net`` inside ``az.root``
and the final pick's win check an ``az.wins`` inside ``az.search``.
Counters: ``az.searches``, ``az.net_rows`` (B an evaluation),
``az.descend_trips`` and ``az.backup_trips`` (the host syncs the loops
issue), ``az.lane_steps`` (B a descent step) and ``az.live_steps`` (the
lanes live at each descent step, summed on the device).
"""

from __future__ import annotations

import torch

from gobblet_rl_torch.core.types import NUM_ACTIONS as A
from gobblet_rl_torch.kernels import wins
from gobblet_rl_torch.ops import batched_core as bc
from gobblet_rl_torch.search.gumbel import (
    GumbelConfig,
    _considered_counts,
    _mixed_value,
    _phase_table,
    _sigma,
)
from gobblet_rl_torch.utils import profiling

MAX_DEPTH = 40  # the descent's depth cap (gumbel_lm.py:241 of the JAX package)


# ---------------------------------------------------------------------------
# per-lane row selects (node index per lane, lane axis last)
# ---------------------------------------------------------------------------
def _row(X: torch.Tensor, node: torch.Tensor) -> torch.Tensor:
    """Per-lane row gather: X[M, 54, B], node int64[B] -> X[node[b], :, b]."""
    return X.gather(0, node.view(1, 1, -1).expand(1, X.shape[1], -1))[0]


def _scal(X: torch.Tensor, node: torch.Tensor) -> torch.Tensor:
    """Per-lane scalar gather: X[M, B], node int64[B] -> X[node[b], b]."""
    return X.gather(0, node.view(1, -1))[0]


def _board_at(boards: torch.Tensor, node: torch.Tensor) -> torch.Tensor:
    """boards int8[M, 3, 9, B], node int64[B] -> int8[3, 9, B]."""
    return boards.gather(0, node.view(1, 1, 1, -1).expand(1, 3, 9, -1))[0]


def _top_k_mask_lm(score: torch.Tensor, k: int) -> torch.Tensor:
    """bool[54, B]: per lane, the entries with rank < k, tie-inclusive
    (rank = how many entries are strictly greater).  Not ``torch.topk``,
    which breaks ties and would change the considered set."""
    rank = (score[None, :, :] > score[:, None, :]).sum(1)
    return rank < k


def _mixed_value_lm(v_hat, q, n, priors, legal):
    """The mixed-value estimator over [54, B] rows -> [B]."""
    return _mixed_value(v_hat, q, n, priors, legal, dim=0)


# ---------------------------------------------------------------------------
# batched rules ops on the lane-major engine
# ---------------------------------------------------------------------------
def _evaluate_lm(net, board: torch.Tensor, player: torch.Tensor):
    """(priors [54, B], tanh(value) [B], legal mask [54, B]) of boards
    int8[3, 9, B]; ``net`` maps obs int8[B, 117] to (logits, value)."""
    with profiling.annotate("az.net"):
        profiling.count("az.net_rows", player.shape[0])
        logits, value = net(bc.features_lm(board, player).t())
        mask = bc.legal_mask_planes(board, player)
        priors = torch.softmax(torch.where(mask, logits.t(), -1e9), dim=0)
        return priors, torch.tanh(value), mask


def _winning_actions_lm(board: torch.Tensor, player: torch.Tensor) -> torch.Tensor:
    """bool[54, B]: the legal immediate wins per lane
    (:func:`gobblet_rl_torch.kernels.wins.winning_actions`: the hand-written
    kernel for CUDA tensors, the folded 54·B engine call for CPU ones)."""
    with profiling.annotate("az.wins"):
        return wins.winning_actions(board.contiguous(), player.to(torch.int32).contiguous())


def _apply_and_winner_lm(board, player, action):
    """(next boards int8[3, 9, B], winner int8[B]); actions must be legal."""
    stepped = bc.apply_action_unchecked(board, player, action)
    return stepped, bc.winner_planes(bc.flat_planes(stepped))


# ---------------------------------------------------------------------------
# the tree, shared with the PUCT search
# ---------------------------------------------------------------------------
class _Tree:
    """The lane-major tree arrays of one batched search, written in place.

    Row ``s + 1`` is the node simulation ``s`` expands (or an unused row,
    if that simulation reselected a proven leaf).  ``node_value`` holds each
    node's leaf value; the Gumbel search also stores the root's net value
    in row 0, which is then its per-node value estimate (``V`` in JAX)."""

    def __init__(self, num_sims: int, board_lm: torch.Tensor, players: torch.Tensor):
        M, B, dev = num_sims + 1, players.shape[0], players.device
        f32, i64 = torch.float32, torch.int64
        self.lanes = torch.arange(B, device=dev)
        self.boards = torch.zeros((M, 3, 9, B), dtype=torch.int8, device=dev)
        self.boards[0] = board_lm
        self.players = torch.zeros((M, B), dtype=torch.int32, device=dev)
        self.players[0] = players
        self.terminal = torch.zeros((M, B), dtype=torch.bool, device=dev)
        self.node_value = torch.zeros((M, B), dtype=f32, device=dev)
        self.P = torch.zeros((M, A, B), dtype=f32, device=dev)
        self.N = torch.zeros((M, A, B), dtype=f32, device=dev)
        self.W = torch.zeros((M, A, B), dtype=f32, device=dev)
        self.legal = torch.zeros((M, A, B), dtype=torch.bool, device=dev)
        self.children = torch.full((M, A, B), -1, dtype=i64, device=dev)
        self.parent = torch.full((M, B), -1, dtype=i64, device=dev)
        self.pa = torch.full((M, B), -1, dtype=i64, device=dev)

    def descend(self, root_action, select, trips: int):
        """Masked lockstep walk from the root: a lane advances to the child
        of its (node, action) while the node is not proven and the child
        exists, then picks ``select(node)``.  At step k every live lane is
        k deep, so ``trips`` = min(sim, depth cap) is also the cap."""
        node = torch.zeros_like(root_action)
        action, live = root_action, None
        tracing, steps, syncs = profiling.enabled(), 0, 0
        for step in range(trips):
            if step:
                syncs += 1
                if not bool(live.any()):
                    break
            child = self.children[node, action, self.lanes]
            advance = ~_scal(self.terminal, node) & (child >= 0)
            live = advance if live is None else live & advance
            node = torch.where(live, child, node)
            action = torch.where(live, select(node), action)
            steps += 1
            if tracing:   # a device sum, only while tracing
                profiling.count("az.live_steps", live.sum())
        profiling.count("az.descend_trips", syncs)
        profiling.count("az.lane_steps", steps * self.lanes.shape[0])
        return node, action

    def expand(self, sim: int, node, action, net):
        """Grow node ``sim + 1`` at every lane's (node, action) unless the
        node is proven (terminal, or its mover wins in one); returns
        ``(start node of the backup, value to back up)``."""
        new = sim + 1
        is_term = _scal(self.terminal, node)
        cur_player = _scal(self.players, node)
        nboard, winner = _apply_and_winner_lm(_board_at(self.boards, node), cur_player, action)
        nplayer = 1 - cur_player
        nterminal = winner != 0
        npriors, nvalue, nmask = _evaluate_lm(net, nboard, nplayer)
        can_win = _winning_actions_lm(nboard, nplayer).any(0)
        leaf_value = torch.where(nterminal, -1.0, torch.where(can_win, 1.0, nvalue))

        expand = ~is_term
        self.boards[new] = torch.where(expand, nboard, self.boards[new])
        self.players[new] = torch.where(expand, nplayer, self.players[new])
        self.terminal[new] = torch.where(expand, nterminal | can_win, self.terminal[new])
        self.P[new] = torch.where(expand, npriors, self.P[new])
        self.legal[new] = torch.where(expand, nmask, self.legal[new])
        self.node_value[new] = torch.where(expand, leaf_value, self.node_value[new])
        self.parent[new] = torch.where(expand, node, self.parent[new])
        self.pa[new] = torch.where(expand, action, self.pa[new])
        edge = (node, action, self.lanes)
        self.children[edge] = torch.where(expand, new, self.children[edge])

        # a reselected proven leaf backs up its stored value (node < new,
        # so the row written above is not read here)
        backup_value = torch.where(is_term, _scal(self.node_value, node), leaf_value)
        return torch.where(is_term, node, new), backup_value

    def backup(self, node, value, trips: int) -> None:
        """Walk parent pointers to the root, adding a visit and the
        sign-flipped value to each edge on the way.  A lane at the root
        (node 0) or past it (-1) has nothing left to add."""
        syncs = 0
        for step in range(trips):
            if step:
                syncs += 1
                if not bool((node > 0).any()):
                    break
            nc = node.clamp(min=0)
            par = torch.where(node > 0, _scal(self.parent, nc), -1)
            act = _scal(self.pa, nc)
            value = -value
            upd = par >= 0
            # one edge a lane, so the read-add-write has no duplicate index
            edge = (par.clamp(min=0), act.clamp(min=0), self.lanes)
            self.N[edge] += upd.to(torch.float32)
            self.W[edge] += torch.where(upd, value, 0.0)
            node = par
        profiling.count("az.backup_trips", syncs)


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------
@torch.no_grad()
def gumbel_search_lm(net, board_lm: torch.Tensor, players: torch.Tensor,
                     generator: torch.Generator | None, config: GumbelConfig,
                     noise: torch.Tensor | None = None):
    """Batched search over lane-major roots.

    ``board_lm`` int8[3, 9, B], ``players`` int32[B] -> (actions int32[B],
    pi f32[B, 54], q f32[B, 54], visits f32[B, 54], root_value f32[B]) —
    the contract of :func:`gobblet_rl_torch.search.gumbel.gumbel_search`.

    ``noise`` (f32[54, B], optional) replaces the root Gumbel field drawn
    from ``generator``."""
    with profiling.annotate("az.search"):
        profiling.count("az.searches", 1)
        return _search(net, board_lm, players, generator, config, noise)


def _search(net, board_lm, players, generator, config, noise):
    """The body of :func:`gumbel_search_lm`, inside its span."""
    B, dev = players.shape[0], players.device
    phase = _phase_table(config.num_sims, config.max_considered)
    counts = _considered_counts(config.max_considered, int(phase[-1]) + 1)
    with profiling.annotate("az.root"):
        tree = _Tree(config.num_sims, board_lm, players)
        N, W = tree.N, tree.W

        priors0, value0, mask0 = _evaluate_lm(net, board_lm, players)
        tree.P[0], tree.node_value[0], tree.legal[0] = priors0, value0, mask0

        g = noise if noise is not None else bc.gumbel_field(generator, (A, B), dev)
        logp0 = torch.where(mask0, torch.log(priors0.clamp(min=1e-12)), -torch.inf)
        considered = mask0 & _top_k_mask_lm(torch.where(mask0, g + logp0, -torch.inf),
                                            int(counts[0]))

    def root_score():
        n0, w0 = N[0], W[0]
        q0 = torch.where(n0 > 0, w0 / n0.clamp(min=1.0), 0.0)
        return torch.where(mask0, g + logp0 + _sigma(q0, n0.amax(0), config), -torch.inf)

    def interior_action(node):
        n, w, p = _row(N, node), _row(W, node), _row(tree.P, node)
        leg, v_hat = _row(tree.legal, node), _scal(tree.node_value, node)
        q = torch.where(n > 0, w / n.clamp(min=1.0), 0.0)
        logp = torch.where(leg, torch.log(p.clamp(min=1e-12)), -torch.inf)
        v_mix = _mixed_value_lm(v_hat, q, n, p, leg)
        completed = torch.where(n > 0, q, v_mix[None])
        imp = torch.where(leg, logp + _sigma(completed, n.amax(0), config), -torch.inf)
        pi = torch.softmax(imp, dim=0)
        score = torch.where(leg, pi - n / (1.0 + n.sum(0)), -torch.inf)
        return score.argmax(0)

    for sim in range(config.num_sims):
        trips = min(sim, MAX_DEPTH)
        with profiling.annotate("az.descend"):
            sc = root_score()
            if sim and phase[sim] != phase[sim - 1]:   # halve by the current score
                k = int(counts[phase[sim]])
                considered = considered & _top_k_mask_lm(torch.where(considered, sc, -torch.inf),
                                                         k)
            # fewest visits first among the considered actions
            root_action = torch.where(considered, -N[0] * 1e4 + sc, -torch.inf).argmax(0)
            node, action = tree.descend(root_action, interior_action, trips)
        with profiling.annotate("az.expand"):
            start, value = tree.expand(sim, node, action, net)
        with profiling.annotate("az.backup"):
            tree.backup(start, value, trips + 1)

    n0, w0 = N[0], W[0]
    root_q = torch.where(n0 > 0, w0 / n0.clamp(min=1.0), -torch.inf)
    # search-proven outcomes dominate (tanh-bounded net values reach +-1
    # only through terminal and solver backups)
    proven_win = (n0 > 0) & (w0 >= 0.999 * n0.clamp(min=1.0))
    proven_loss = (n0 > 0) & (w0 <= -0.999 * n0.clamp(min=1.0))
    final_sc = root_score() + 1e6 * proven_win - 1e6 * proven_loss
    action = torch.where(considered, final_sc, -torch.inf).argmax(0)

    # exact 1-ply root override: the lowest-index immediate win
    root_win = _winning_actions_lm(board_lm, players)
    any_win = root_win.any(0)
    action = torch.where(any_win, root_win.to(torch.uint8).argmax(0), action)

    # training target: the improved policy with completed Q (no noise)
    q0 = torch.where(n0 > 0, w0 / n0.clamp(min=1.0), 0.0)
    v_mix0 = _mixed_value_lm(value0, q0, n0, priors0, mask0)
    q_comp = torch.where(n0 > 0, q0, v_mix0[None])
    imp = torch.where(mask0, logp0 + _sigma(q_comp, n0.amax(0), config), -torch.inf)
    pi_target = torch.softmax(imp, dim=0)
    root_value = torch.where(any_win, 1.0, v_mix0)
    return action.to(torch.int32), pi_target.t(), root_q.t(), n0.t(), root_value


def gumbel_lm_policy(net, config: GumbelConfig = GumbelConfig()):
    """Tournament policy ``(generator, board_lm [3, 9, B], current [B]) ->
    int32[B]`` (see eval/tournament.py)."""

    def fn(generator, board_lm, current):
        return gumbel_search_lm(net, board_lm, current, generator, config)[0]

    return fn
