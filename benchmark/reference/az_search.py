"""The Gumbel AlphaZero search, written per root as a plain tree.

Danihelka, Guez, Schrittwieser and Silver, "Policy improvement by planning
with Gumbel" (ICLR 2022), as google-deepmind/mctx's
``gumbel_muzero_policy`` states it:

* at the root, Gumbel noise ``g`` over the legal actions; the ``m``
  actions with the largest ``g + log pi`` are considered;
* sequential halving: simulations go to the considered action with the
  fewest visits (the largest score among those), and between phases the
  set is halved, ranked by ``g + log pi + sigma(q)`` with
  ``sigma(q) = (c_visit + max_b N(b)) * c_scale * q``;
* at an interior node the deterministic selection
  ``argmax_a pi'(a) - N(a) / (1 + sum_b N(b))``, ``pi' = softmax(log pi +
  sigma(completed Q))``, where an unvisited action's Q is completed by the
  mixed value ``(v + sum N * sum_{N>0} pi q / sum_{N>0} pi) / (1 + sum N)``;
* the action played is the considered one with the largest
  ``g + log pi + sigma(q)``; the target is ``softmax(log pi + sigma(completed
  Q))`` at the root, and the root's value its mixed value.

The program's own choices, each a departure from the paper, are kept here
so that the two can be compared (they are listed in ``PERF.md`` too):

1. **One-move certification.** A node whose player to move has a legal
   move that wins at once is proven: its value is +1 and it is never
   expanded (a simulation that reaches it backs up +1 again).  A node
   where the game has ended is valued -1 for its player to move, as the
   program scores it, whichever side's line ended it.
2. **The root's immediate win.** If the root's player can win in one, the
   lowest-numbered winning action is played and the root's value is 1.
3. **Proven outcomes at the final pick.** A considered action whose every
   visit returned a win (``W >= 0.999 N``) gains 1e6, one whose every
   visit returned a loss loses 1e6.
4. **Depth cap.** A descent stops after ``min(simulation, 40)`` steps.
5. **Tie-inclusive top-k.** Every action with fewer than ``k`` strictly
   larger scores is kept, so a tie at the cut keeps more than ``k``.
6. **log pi** is ``log(max(pi, 1e-12))``.
7. **The halving schedule.** The simulations are split evenly over
   ``ceil(log2 m)`` phases (the last takes the remainder), phase ``p``
   keeping ``max(2, m >> p)`` actions; the paper's schedule gives each
   considered action ``max(1, n // (ceil(log2 m) * m_p))`` visits a phase
   (:func:`paper_schedule`).

The tree's arithmetic is float32 (numpy, one node's 54 actions at a
time); the boards of one simulation's leaves, over all roots, are played,
judged and evaluated together, by the benchmark's own rules
(:mod:`benchmark.reference.rules`) and the caller's ``evaluate``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import az, rules

F32 = np.float32
MAX_DEPTH = 40
NEG_INF = F32(-np.inf)


def phase_table(num_sims: int, m: int) -> np.ndarray:
    """The phase of each simulation, the program's even split (departure 7)."""
    m = max(2, m)
    phases = max(1, math.ceil(math.log2(m)))
    per = max(1, num_sims // phases)
    return np.minimum(np.arange(num_sims) // per, phases - 1)


def considered_count(m: int, phase: int) -> int:
    return max(2, max(2, m) >> phase)


def paper_schedule(num_sims: int, m: int) -> list:
    """The number of considered actions at each simulation under the
    paper's sequential halving (mctx's ``get_sequence_of_considered_visits``:
    each phase visits every considered action ``max(1, n // (log2 m *
    m_p))`` times, then halves)."""
    log2m = math.ceil(math.log2(m))
    out, considered = [], m
    while len(out) < num_sims:
        extra = max(1, num_sims // (log2m * considered))
        out += [considered] * (extra * considered)
        considered = max(2, considered // 2)
    return out[:num_sims]


def top_k(score: np.ndarray, k: int) -> np.ndarray:
    """bool[54]: the entries with fewer than ``k`` strictly larger ones."""
    return (score[None, :] > score[:, None]).sum(1) < k


def softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max())
    return e / e.sum()


def log_prior(p, legal):
    return np.where(legal, np.log(np.maximum(p, F32(1e-12))), NEG_INF)


def mixed_value(v_hat, q, n, p, legal):
    """The paper's mixed value estimator (its appendix D); the net's value
    where no legal action is visited."""
    visited = (n > 0) & legal
    pi = np.where(legal, p, F32(0))
    pi = pi / max(pi.sum(), F32(1e-12))
    w_vis = np.where(visited, pi, F32(0)).sum()
    if not w_vis > 0:
        return v_hat
    q_avg = np.where(visited, pi * q, F32(0)).sum() / max(w_vis, F32(1e-12))
    sum_n = n.sum()
    return (v_hat + sum_n * q_avg) / (F32(1) + sum_n)


def evaluator(params: dict, quant=None):
    """``evaluate(board int8[n, 3, 9], player int32[n]) -> (priors
    float32[n, 54], tanh(value) float32[n], legal bool[n, 54])`` by the
    reference net at ``params`` (through ``quant``, if given)."""

    def evaluate(board, player):
        logits, value = az.forward(params, rules.features(board, player), quant)
        legal = rules.legal_mask(board, player)
        return az.priors(logits, legal), torch.tanh(value), legal

    return evaluate


class Node:
    """One position of a tree: its board and player to move, the net's
    priors and legal moves there, its value, whether it is proven, and per
    action the visits ``N``, the summed values ``W`` (its player's side)
    and the child."""

    __slots__ = ("board", "player", "P", "legal", "value", "proven", "N", "W", "children",
                 "parent", "action")

    def __init__(self, board, player, P, legal, value, proven, parent=None, action=None):
        self.board, self.player, self.P, self.legal = board, player, P, legal
        self.value, self.proven = F32(value), proven
        self.N = np.zeros(54, F32)
        self.W = np.zeros(54, F32)
        self.children = {}
        self.parent, self.action = parent, action


class Search:
    """The searches of many roots, each its own tree, advanced one
    simulation at a time over all of them.  ``flip=False`` backs up
    without the change of side, ``halving=False`` keeps the first
    considered set: the faults the benchmark's calibration reads."""

    def __init__(self, config: dict, evaluate, device, flip: bool = True,
                 halving: bool = True):
        self.n = config["num_sims"]
        self.m = config["max_considered"]
        self.c_visit, self.c_scale = F32(config["c_visit"]), F32(config["c_scale"])
        self.evaluate, self.device = evaluate, device
        self.flip, self.halving = flip, halving
        self.phase = phase_table(self.n, self.m)

    def sigma(self, q, n):
        return (self.c_visit + n.max()) * self.c_scale * q

    def select(self, node: Node) -> int:
        """The interior selection at ``node``."""
        n, w, p, legal = node.N, node.W, node.P, node.legal
        q = np.where(n > 0, w / np.maximum(n, F32(1)), F32(0))
        completed = np.where(n > 0, q, mixed_value(node.value, q, n, p, legal))
        imp = np.where(legal, log_prior(p, legal) + self.sigma(completed, n), NEG_INF)
        with np.errstate(invalid="ignore"):
            pi = softmax(imp)
        score = np.where(legal, pi - n / (F32(1) + n.sum()), NEG_INF)
        return int(np.argmax(score))

    def root_score(self, root: Node, g):
        n = root.N
        q = np.where(n > 0, root.W / np.maximum(n, F32(1)), F32(0))
        return np.where(root.legal, g + log_prior(root.P, root.legal) + self.sigma(q, n),
                        NEG_INF)

    def _expand_all(self, boards, players, actions):
        """Play ``actions`` on the leaves' boards; the next boards, the
        ended games, the net's priors, values and legal moves there, and
        whether their player to move wins in one."""
        dev = self.device
        board = torch.from_numpy(np.stack(boards)).to(dev)
        player = torch.tensor(players, dtype=torch.int32, device=dev)
        action = torch.tensor(actions, dtype=torch.int64, device=dev)
        nboard = rules.apply(board, player, action)
        ended = rules.winner(nboard) != 0
        nplayer = 1 - player
        P, value, legal = self.evaluate(nboard, nplayer)
        wins = rules.winner(rules.apply_all(nboard, nplayer).view(-1, 3, 9)).view(-1, 54)
        can_win = (legal & (wins == rules.sign(nplayer)[:, None])).any(1)
        return (nboard.cpu().numpy(), ended.cpu().numpy(), P.cpu().numpy(),
                value.cpu().numpy(), legal.cpu().numpy(), can_win.cpu().numpy())

    def run(self, board: torch.Tensor, player: torch.Tensor, gumbel: torch.Tensor) -> dict:
        """Search from ``board`` int8[R, 3, 9], ``player`` int32[R] with the
        root noise ``gumbel`` float32[R, 54].  Returns numpy arrays:
        ``action`` [R], ``visits`` [R, 54], ``q`` [R, 54] (0 where
        unvisited), ``pi`` [R, 54], ``value`` [R], and by simulation the
        steps each descent took ``advances`` [n, R] and the depth its backup
        started from ``depth`` [n, R]."""
        R = board.shape[0]
        board, player = board.to(self.device), player.to(self.device)
        P0, v0, legal0 = (x.cpu().numpy() for x in self.evaluate(board, player))
        g = gumbel.cpu().numpy().astype(F32)
        boards, players = board.cpu().numpy(), player.cpu().numpy()
        roots = [Node(boards[r], int(players[r]), P0[r], legal0[r], v0[r], False)
                 for r in range(R)]
        considered = [legal0[r] & top_k(np.where(legal0[r], g[r] + log_prior(P0[r], legal0[r]),
                                                 NEG_INF), considered_count(self.m, 0))
                      for r in range(R)]
        advances = np.zeros((self.n, R), np.int64)
        depth = np.zeros((self.n, R), np.int64)
        for sim in range(self.n):
            leaves = []
            for r, root in enumerate(roots):
                sc = self.root_score(root, g[r])
                if self.halving and sim and self.phase[sim] != self.phase[sim - 1]:
                    k = considered_count(self.m, int(self.phase[sim]))
                    considered[r] = considered[r] & top_k(np.where(considered[r], sc, NEG_INF), k)
                action = int(np.argmax(np.where(considered[r], -root.N * F32(1e4) + sc,
                                                NEG_INF)))
                node, steps = root, 0
                while steps < min(sim, MAX_DEPTH) and not node.proven \
                        and action in node.children:
                    node = node.children[action]
                    action = self.select(node)
                    steps += 1
                advances[sim, r] = steps
                leaves.append((node, action, steps))
            grow = [i for i, (node, _, _) in enumerate(leaves) if not node.proven]
            if grow:
                grown = self._expand_all([leaves[i][0].board for i in grow],
                                         [leaves[i][0].player for i in grow],
                                         [leaves[i][1] for i in grow])
            at = {i: j for j, i in enumerate(grow)}
            for r, (node, action, steps) in enumerate(leaves):
                if node.proven:
                    start, value = node, node.value
                else:
                    nboard, ended, P, v, legal, can_win = (x[at[r]] for x in grown)
                    value = F32(-1) if ended else (F32(1) if can_win else F32(v))
                    start = Node(nboard, 1 - node.player, P, legal, value,
                                 bool(ended or can_win), node, action)
                    node.children[action] = start
                    steps += 1
                depth[sim, r] = steps
                self.backup(start, value)
        return self.finish(roots, considered, g, board, player, advances, depth)

    def backup(self, node: Node, value) -> None:
        """A visit and the value, from each parent's side, on every edge
        from ``node`` up to the root."""
        while node.parent is not None:
            if self.flip:
                value = -value
            node.parent.N[node.action] += F32(1)
            node.parent.W[node.action] += value
            node = node.parent

    def target(self, P, legal, value, n, q):
        """The improved policy ``softmax(log pi + sigma(completed Q))`` and
        the mixed value of a root with priors ``P``, legal moves, the net's
        value, visits ``n`` and mean values ``q`` (0 where unvisited)."""
        v_mix = mixed_value(value, q, n, P, legal)
        completed = np.where(n > 0, q, v_mix)
        imp = np.where(legal, log_prior(P, legal) + self.sigma(completed, n), NEG_INF)
        return softmax(imp), F32(v_mix)

    def finish(self, roots, considered, g, board, player, advances, depth) -> dict:
        legal = torch.from_numpy(np.stack([root.legal for root in roots])).to(board.device)
        root_win = immediate_wins(board, player, legal)
        out = {k: [] for k in ("action", "visits", "q", "pi", "value")}
        for r, root in enumerate(roots):
            n, w = root.N, root.W
            proven_win = (n > 0) & (w >= F32(0.999) * np.maximum(n, F32(1)))
            proven_loss = (n > 0) & (w <= F32(-0.999) * np.maximum(n, F32(1)))
            final = self.root_score(root, g[r]) + F32(1e6) * proven_win - F32(1e6) * proven_loss
            action = int(np.argmax(np.where(considered[r], final, NEG_INF)))
            if root_win[r].any():
                action = int(np.argmax(root_win[r]))
            q = np.where(n > 0, w / np.maximum(n, F32(1)), F32(0))
            pi, v_mix = self.target(root.P, root.legal, root.value, n, q)
            out["action"].append(action)
            out["visits"].append(n.copy())
            out["q"].append(q)
            out["pi"].append(pi)
            out["value"].append(F32(1) if root_win[r].any() else v_mix)
        res = {k: np.array(v) for k, v in out.items()}
        res["advances"], res["depth"] = advances, depth
        return res


def immediate_wins(board: torch.Tensor, player: torch.Tensor, legal: torch.Tensor) -> np.ndarray:
    """bool[R, 54]: the legal moves that win at once for the player to move."""
    wins = rules.winner(rules.apply_all(board, player).view(-1, 3, 9)).view(-1, 54)
    return (legal & (wins == rules.sign(player)[:, None])).cpu().numpy()
