"""Interactive human policy driven by pygame events.

Port of ``gobblet_rl_tpu/interactive/manual_policy.py``, the reference's
manual policy: the mouse's cell is the target, keys 1/2/3 select a piece
size, SPACE cycles the sizes of the still-unplaced pieces from largest to
smallest, hovering previews the move in ``board.squares_preview``,
clicking an own top piece picks it up (the action mask is rewritten to
that piece's moves only) and clicking a legal target returns the action.
Host only: ``pygame`` is imported when the policy is called.
"""

from __future__ import annotations

import sys

import numpy as np


class ManualGobbletPolicy:
    def __init__(self, env, agent_id: int = 0, recorder=None):
        self.env = env
        self.agent_id = agent_id
        self.agent = self.env.agents[self.agent_id]
        self.recorder = recorder
        env.render()  # pygame needs a window before it can take input

    @staticmethod
    def _mouse_cell(mousex, mousey, width, height) -> int:
        """Screen coords -> column-major cell 0-8 (manual_policy.py:39-55)."""

        def axis_band(v, extent):
            if v < 360 * extent / 1000:
                return 0
            if v < 640 * extent / 1000:
                return 1
            return 2

        return axis_band(mousey, height) + 3 * axis_band(mousex, width)

    def __call__(self, observation, agent):
        import pygame

        env = self.env
        board = env.unwrapped.board

        picked_up = False
        picked_up_pos = -1
        piece_cycle = 0
        piece_size_selected = 0
        piece = -1

        while True:
            event = pygame.event.wait()

            if event.type == pygame.QUIT:
                if self.recorder is not None:
                    self.recorder.end_recording(env.unwrapped.screen)
                pygame.quit()
                pygame.display.quit()
                sys.exit()

            mousex, mousey = pygame.mouse.get_pos()
            width, height = pygame.display.get_surface().get_size()
            pos = self._mouse_cell(mousex, mousey, width, height)

            agent_multiplier = 1 if agent == env.agents[0] else -1
            agent_index = env.agents.index(agent)

            placed = board.squares[board.squares.nonzero()]
            placed_mine = [p for p in placed if np.sign(p) == agent_multiplier]
            placed_mine_abs = [abs(p) for p in placed_mine]
            unplaced = [p for p in range(1, 7) if p not in placed_mine_abs]
            flat = board.get_flatboard()

            if piece_size_selected == 0:
                if unplaced:
                    piece = unplaced[-1]
                    piece_size_selected = (piece + 1) // 2
                else:
                    piece = -1

            if event.type == pygame.KEYDOWN and not picked_up:
                if event.key == pygame.K_SPACE:
                    # cycle available sizes largest -> smallest
                    piece_cycle += 1
                    cycle_choices = np.unique([(p + 1) // 2 for p in unplaced])
                    if len(cycle_choices) > 0:
                        piece_size_selected = int(
                            cycle_choices[
                                (np.amax(cycle_choices) - (piece_cycle + 1))
                                % len(cycle_choices)
                            ]
                        )
                    first, second = piece_size_selected * 2 - 1, piece_size_selected * 2
                    piece = first if first in unplaced else second
                else:
                    key_sizes = {pygame.K_1: 1, pygame.K_2: 2, pygame.K_3: 3}
                    if event.key in key_sizes:
                        size = key_sizes[event.key]
                        piece_size_selected = size
                        piece_cycle = 3 - size
                        first, second = size * 2 - 1, size * 2
                        if first in unplaced:
                            piece = first
                        elif second in unplaced:
                            piece = second
                        else:
                            piece = -1

            action_prev = -1
            if piece != -1:
                piece_size = (piece + 1) // 2
                action_prev = board.get_action(pos, piece_size, agent_index)

            if pos == picked_up_pos or piece == -1:
                action_prev = -1

            board.squares_preview[:] = 0
            if action_prev != -1:
                if not board.is_legal(action_prev, agent_index):
                    action_prev = -1
                else:
                    board.squares_preview[pos + 9 * (piece_size - 1)] = agent_multiplier

            env.render()
            pygame.display.update()
            if self.recorder is not None:
                self.recorder.capture_frame(env.unwrapped.screen)

            if event.type == pygame.MOUSEBUTTONDOWN:
                if flat[pos] in placed_mine and not picked_up:
                    # pick up our top piece at this cell (self-gobble aware,
                    # manual_policy.py:174-205)
                    piece_size_on_board = (abs(flat[pos]) + 1) // 2
                    piece_to_pick_up = int(flat[pos])
                    if piece_size_on_board >= piece_size_selected:
                        candidate = abs(piece_to_pick_up)
                        move_mask = observation["action_mask"][
                            9 * (candidate - 1) : 9 * candidate
                        ]
                        if not all(move_mask == 0):
                            piece = candidate
                            picked_up = True
                            picked_up_pos = pos
                            piece_size_selected = (piece + 1) // 2
                            index = np.where(board.squares == piece_to_pick_up)[0][0]
                            board.squares[index] = 0
                            # only this piece's moves remain legal
                            observation["action_mask"][pos + 9 * (piece - 1)] = 0
                            observation["action_mask"][: 9 * (piece - 1)] = 0
                            observation["action_mask"][9 * piece :] = 0
                elif action_prev != -1:
                    board.squares_preview[pos + 9 * (piece_size - 1)] = 0
                    return np.int32(pos + 9 * (piece - 1))

    @property
    def available_agents(self):
        return self.env.agent_name_mapping
