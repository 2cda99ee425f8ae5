"""Procedural pygame renderer for the ``human`` and ``rgb_array`` modes.

Port of ``gobblet_rl_tpu/render/surface.py``: the reference's geometry (3x3
grid, chip radii per size, translucent preview chips for a hover state)
drawn with vector primitives, so no image assets are shipped.  Red is
player_1, yellow player_2.  ``pygame`` is imported inside the functions
that draw.
"""

from __future__ import annotations

import numpy as np

BACKGROUND = (27, 94, 32)
GRID_COLOR = (240, 240, 235)
RED = (198, 40, 40)
RED_RIM = (127, 20, 20)
YELLOW = (249, 200, 14)
YELLOW_RIM = (158, 126, 9)

# chip radius per level, as a fraction of the tile size (the reference's
# 4/13, 6/13, 9/13 sprite scales)
_SCALE = {0: 4 / 13, 1: 6 / 13, 2: 9 / 13}

# hover previews are semi-transparent, like the reference's preview sprites
PREVIEW_ALPHA = 128


def _cell_center(cell: int, width: int) -> tuple[int, int]:
    """Pixel center of display cell 0-8 (column-major like the reference:
    x from cell//3, y from cell%3)."""
    tile = width / 3
    x = int(cell // 3 * tile + tile / 2)
    y = int(cell % 3 * tile + tile / 2)
    return x, y


def draw_board(screen, squares, squares_preview, width: int) -> None:
    """Draw the full board state onto a pygame surface."""
    import pygame

    screen.fill(BACKGROUND)
    tile = width / 3
    for i in (1, 2):
        pygame.draw.line(screen, GRID_COLOR, (int(i * tile), 0), (int(i * tile), width), 4)
        pygame.draw.line(screen, GRID_COLOR, (0, int(i * tile)), (width, int(i * tile)), 4)

    squares = np.asarray(squares).reshape(3, 9)
    # draw small -> large so bigger pieces visually gobble smaller ones
    for level in range(3):
        radius = int(tile * _SCALE[level] / 2)
        for cell in range(9):
            piece = squares[level, cell]
            if piece == 0:
                continue
            color, rim = (RED, RED_RIM) if piece > 0 else (YELLOW, YELLOW_RIM)
            center = _cell_center(cell, width)
            pygame.draw.circle(screen, color, center, radius)
            pygame.draw.circle(screen, rim, center, radius, max(2, radius // 8))

    preview = np.asarray(squares_preview).reshape(3, 9)
    if (preview != 0).any():
        # translucent chip ghost + solid outline, composited in one blit
        overlay = pygame.Surface((width, width), pygame.SRCALPHA)
        for level in range(3):
            radius = int(tile * _SCALE[level] / 2)
            for cell in range(9):
                mark = preview[level, cell]
                if mark == 0:
                    continue
                color = RED if mark > 0 else YELLOW
                center = _cell_center(cell, width)
                pygame.draw.circle(overlay, (*color, PREVIEW_ALPHA), center, radius)
                pygame.draw.circle(overlay, (*color, 255), center, radius, 3)
        screen.blit(overlay, (0, 0))


def surface_to_rgb_array(screen) -> np.ndarray:
    """(H, W, 3) uint8 frame, transposed like the reference's rgb_array
    output."""
    import pygame

    frame = np.array(pygame.surfarray.pixels3d(screen))
    return np.transpose(frame, axes=(1, 0, 2))
