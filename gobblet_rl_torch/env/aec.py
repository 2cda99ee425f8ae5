"""PettingZoo AEC env: the reference's ``gobblet_v1`` API on the host.

Port of ``gobblet_rl_tpu/env/aec.py``: the same agent names, spaces,
step/reset/observe/render semantics and wrapper stack, with every rule a
:mod:`gobblet_rl_torch.core.rules_np` call.  This module and
:mod:`gobblet_rl_torch.gobblet_v1` are the only ones of the port that
import ``pettingzoo`` and ``gymnasium``; the batched env on the card is
:mod:`gobblet_rl_torch.env.vector`.
"""

from __future__ import annotations

import numpy as np
from gymnasium import spaces
from pettingzoo import AECEnv
from pettingzoo.utils import wrappers
from pettingzoo.utils.agent_selector import AgentSelector  # pettingzoo >= 1.24
from pettingzoo.utils.conversions import parallel_wrapper_fn

from gobblet_rl_torch.board import Board
from gobblet_rl_torch.core import observe as obs_kernel
from gobblet_rl_torch.core import rules_np
from gobblet_rl_torch.core import types as T
from gobblet_rl_torch.render import text as text_render


def env(render_mode=None, args=None):
    """Wrapped env factory, with the reference's wrapper stack."""
    _env = raw_env(render_mode=render_mode, args=args)
    if render_mode == "ansi":
        _env = wrappers.CaptureStdoutWrapper(_env)
    _env = wrappers.TerminateIllegalWrapper(_env, illegal_reward=-1)
    _env = wrappers.AssertOutOfBoundsWrapper(_env)
    _env = wrappers.OrderEnforcingWrapper(_env)
    return _env


parallel_env = parallel_wrapper_fn(env)


class raw_env(AECEnv):
    """Two-player AEC Gobblet."""

    metadata = {
        "render_modes": ["human", "rgb_array", "text", "text_full"],
        "name": "gobblet_v1",
        "is_parallelizable": True,
        "render_fps": 60,
        "has_manual_policy": True,
    }

    def __init__(self, render_mode=None, args=None):
        super().__init__()
        self.board = Board()
        self.board_size = 3

        self.agents = ["player_1", "player_2"]
        self.possible_agents = self.agents[:]

        self.action_spaces = {i: spaces.Discrete(T.NUM_ACTIONS) for i in self.agents}
        self.observation_spaces = {
            i: spaces.Dict(
                {
                    "observation": spaces.Box(
                        low=0, high=1, shape=(3, 3, T.OBS_CHANNELS), dtype=np.int8
                    ),
                    "action_mask": spaces.Box(
                        low=0, high=1, shape=(T.NUM_ACTIONS,), dtype=np.int8
                    ),
                }
            )
            for i in self.agents
        }

        self.rewards = {i: 0 for i in self.agents}
        self.terminations = {i: False for i in self.agents}
        self.truncations = {i: False for i in self.agents}
        self.infos = {i: {"legal_moves": list(range(0, 9))} for i in self.agents}

        self._agent_selector = AgentSelector(self.agents)
        self.agent_selection = self._agent_selector.reset()

        self.render_mode = render_mode
        self.debug = args.debug if hasattr(args, "debug") else False
        self.screen_width = args.screen_width if hasattr(args, "screen_width") else 640
        self.screen_height = self.screen_width
        self.screen = None

    # ------------------------------------------------------------------
    def observe(self, agent):
        """(3,3,13) planes and the 54-way mask of ``agent``."""
        idx = self.agents.index(agent)
        current = self.agents.index(self.agent_selection)
        observation, action_mask = obs_kernel.observe_np(
            self.board._grid(), idx, current
        )
        return {"observation": observation, "action_mask": action_mask}

    def observation_space(self, agent):
        return self.observation_spaces[agent]

    def action_space(self, agent):
        return self.action_spaces[agent]

    def _legal_moves(self):
        mask = rules_np.legal_mask(
            self.board._grid(), self.agents.index(self.agent_selection)
        )
        return [int(a) for a in np.nonzero(mask)[0]]

    # ------------------------------------------------------------------
    def step(self, action):
        if (
            self.terminations[self.agent_selection]
            or self.truncations[self.agent_selection]
        ):
            return self._was_dead_step(action)

        agent_index = self.agents.index(self.agent_selection)
        if self.debug and not self.board.is_legal(action, agent_index):
            print("piece: ", self.board.get_piece_from_action(action))
            print("piece_size: ", self.board.get_piece_size_from_action(action))
            print("pos: ", self.board.get_pos_from_action(action))
            print("--ERROR-- ILLEGAL MOVE")

        # Illegal actions are silent no-ops at this layer; the wrapped env()
        # terminates instead, through TerminateIllegalWrapper.
        self.board.play_turn(agent_index, action)

        next_agent = self._agent_selector.next()

        if self.board.check_game_over():
            winner = self.board.check_for_winner()
            if winner == 1:
                self.rewards[self.agents[0]] += 1
                self.rewards[self.agents[1]] -= 1
            elif winner == -1:
                self.rewards[self.agents[1]] += 1
                self.rewards[self.agents[0]] -= 1
            self.terminations = {i: True for i in self.agents}

        self._cumulative_rewards[self.agent_selection] = 0
        self.agent_selection = next_agent
        self._accumulate_rewards()
        self.turn += 1
        self.action = action
        if self.render_mode in ["human", "text", "text_full", "rgb_array"]:
            self.render()

    def reset(self, seed=None, return_info=False, options=None):
        self.board = Board()
        self.agents = self.possible_agents[:]
        self.rewards = {i: 0 for i in self.agents}
        self._cumulative_rewards = {i: 0 for i in self.agents}
        self.terminations = {i: False for i in self.agents}
        self.truncations = {i: False for i in self.agents}
        self.infos = {i: {} for i in self.agents}
        self._agent_selector.reinit(self.agents)
        self._agent_selector.reset()
        self.agent_selection = self._agent_selector.reset()
        self.turn = 0
        self.action = -1

    # ------------------------------------------------------------------
    def render(self):
        if self.render_mode is None:
            import gymnasium

            gymnasium.logger.warn(
                "You are calling render method without specifying any render mode."
            )
            return

        if self.debug:
            self.board.print_pieces()
        if self.render_mode == "text" or self.debug:
            text_render.print_lines(
                text_render.render_text_lines(
                    self.board.get_flatboard(), self.turn, self.agent_selection, self.action
                )
            )
        elif self.render_mode == "text_full":
            text_render.print_lines(
                text_render.render_text_full_lines(
                    self.board.squares, self.turn, self.agent_selection, self.action
                )
            )
        else:
            import pygame

            from gobblet_rl_torch.render import surface as surface_render

            if self.render_mode == "human":
                if self.screen is None:
                    pygame.init()
                    self.screen = pygame.display.set_mode(
                        (self.screen_width, self.screen_height)
                    )
                pygame.event.get()
            elif self.screen is None:
                pygame.init()
                self.screen = pygame.Surface((self.screen_width, self.screen_height))

            surface_render.draw_board(
                self.screen,
                self.board.squares,
                self.board.squares_preview,
                self.screen_width,
            )
            if self.render_mode == "human":
                pygame.display.update()
            observation = surface_render.surface_to_rgb_array(self.screen)
            return observation if self.render_mode == "rgb_array" else None
        return None

    def close(self):
        if self.screen is not None:
            import pygame

            pygame.quit()
            self.screen = None
