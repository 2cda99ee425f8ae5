"""Host-side greedy search, decision for decision the reference's
``GreedyGobbletPolicy``.

Port of ``gobblet_rl_tpu/policies/greedy.py``.  The board mechanics are
:mod:`gobblet_rl_torch.core.rules_np` calls, but the decision sequence is
the reference's: iteration order, early exits, the pruning list's
mutations, the depth-3 replay quirk (its inner playout replays the
depth-1 action, not the depth-3 candidate), and the fallback drawn from
the global ``np.random`` with last-3-move anti-repetition, so seeded games
follow the reference move for move.  The batched greedy of the lane-major
engine is :mod:`gobblet_rl_torch.policies.greedy_jax`.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from gobblet_rl_torch.board import Board
from gobblet_rl_torch.core import rules_np
from gobblet_rl_torch.core import types as T


def board_from_observation(obs: np.ndarray) -> tuple[np.ndarray, int]:
    """Reconstruct the signed int grid and agent index from (3,3,13)
    planes."""
    own = np.zeros((3, 3, 3))
    opp = np.zeros((3, 3, 3))
    for level in range(3):
        own[level] = (2 * level + 1) * obs[..., 2 * level] + (2 * level + 2) * obs[..., 2 * level + 1]
        opp[level] = (2 * level + 1) * obs[..., 6 + 2 * level] + (2 * level + 2) * obs[..., 6 + 2 * level + 1]
    board = np.where(own > opp, own, -opp)
    agent_index = int(obs[..., 12].max())
    if agent_index == 1:
        board = -board  # back to the canonical agent-0-positive encoding
    return board.reshape(3, 9).astype(np.int8), agent_index


class GreedyGobbletPolicy:
    """Depth-1/2/3 greedy lookahead."""

    def __init__(
        self,
        depth: Optional[int] = 2,
        seed: Optional[int] = 0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.board = None
        self.depth = depth
        self.rng = np.random.default_rng()
        self.prev_actions = {i: [] for i in range(2)}

    # -- framework adapters ----------------------------------------------
    def compute_actions_rllib(self, obs_batch):
        observations = obs_batch["observation"]
        observations = observations.reshape(observations.shape[0], 3, 3, -1)
        masks = obs_batch["action_mask"]
        return [
            self.compute_action(observations[i], masks[i])
            for i in range(len(observations))
        ]

    def compute_action_tianshou(self, obs):
        mask = obs.mask
        obs = obs.obs if hasattr(obs, "obs") else obs
        return self.compute_action(obs, mask)

    # -- core search ----------------------------------------------------
    def compute_action(self, obs, mask) -> np.ndarray:
        grid, agent_index = board_from_observation(np.asarray(obs))
        opponent_index = 1 - agent_index

        # compat: expose the reconstructed position as a Board facade
        self.board = Board()
        self.board.squares = grid.flatten().astype(np.float64)

        winner_values = [1, -1]
        win_mine = winner_values[agent_index]
        win_theirs = winner_values[opponent_index]

        root_mask = rules_np.legal_mask(grid, agent_index)
        legal_actions = np.asarray(mask).flatten().nonzero()[0]
        actions_depth1 = list(legal_actions)
        chosen_action = None

        results = {}
        # Depth 1: immediate wins / losses
        for action in legal_actions:
            if root_mask[action]:
                b1 = rules_np.apply_action(grid, agent_index, int(action))
                results[action] = rules_np.line_winner(b1)
                if results[action] == win_mine:
                    chosen_action = action
                    break
                elif results[action] == win_theirs:
                    if len(actions_depth1) > 1:
                        actions_depth1.remove(action)
                    else:
                        break  # forced: every move loses, keep one

        if self.depth > 1:
            # Depth 2 over neutral depth-1 actions
            for action in [k for k, v in results.items() if v == 0]:
                b1 = rules_np.apply_action(grid, agent_index, int(action))
                legal_depth2 = [
                    int(a) for a in np.nonzero(rules_np.legal_mask(b1, opponent_index))[0]
                ]

                results_depth2 = {}
                for action_depth2 in legal_depth2:
                    b2 = rules_np.apply_action(b1, opponent_index, action_depth2)
                    results_depth2[action_depth2] = rules_np.line_winner(b2)

                    if results_depth2[action_depth2] == win_theirs:
                        if len(actions_depth1) > 1:
                            if action in actions_depth1:
                                actions_depth1.remove(action)
                        else:
                            break  # forced: they win whatever we do
                        # Steal their winning square if nothing is chosen yet
                        if root_mask[action_depth2] and chosen_action is None:
                            chosen_action = action_depth2

                if all(w == win_mine for w in results_depth2.values()):
                    chosen_action = action  # zugzwang: every reply loses for them
                    break
                if all(w != win_theirs for w in results_depth2.values()):
                    chosen_action = action  # blocking move (no break: last wins)

                    if self.depth == 3:
                        # Forced-win continuation scan, replicated with the
                        # reference's replay quirk: the inner playout re-plays
                        # `action`, not the depth-3 candidate.
                        for action_depth2 in [
                            k for k, v in results_depth2.items() if v == 0
                        ]:
                            b2 = rules_np.apply_action(b1, agent_index, action_depth2)
                            legal_depth3 = [
                                int(a)
                                for a in np.nonzero(
                                    rules_np.legal_mask(b2, agent_index)
                                )[0]
                            ]
                            actions_depth3 = list(legal_depth3)
                            for act_depth3 in legal_depth3:
                                b3 = rules_np.apply_action(b2, agent_index, int(action))
                                res = rules_np.line_winner(b3)
                                if res == win_mine:
                                    chosen_action = action
                                    break
                                elif res == win_theirs:
                                    if len(actions_depth3) > 1:
                                        if action in actions_depth3:
                                            actions_depth3.remove(action)
                                    else:
                                        break

        # Random fallback with last-3 anti-repetition.  Uses the GLOBAL numpy
        # RNG exactly like the reference so seeded games stay in lockstep.
        if (
            chosen_action is None
            or chosen_action in self.prev_actions[agent_index][-3:]
        ):
            chosen_action = np.random.choice(actions_depth1)
        self.prev_actions[agent_index].append(chosen_action)
        return np.array(chosen_action)
