"""Text renderers, byte-identical to the reference's terminal output.

Port of ``gobblet_rl_tpu/render/text.py``: the ``text`` and ``text_full``
render modes, as the lines the reference prints, so seeded trajectory
traces can be diffed line for line.
"""

from __future__ import annotations

import numpy as np


def _symbol(value) -> str:
    """Top-piece cell symbol: size with sign, '- ' when empty."""
    if value == 0:
        return "- "
    if value > 0:
        return f"+{int((value + 1) // 2)}"
    return f"{int(value // 2)}"


def _symbol_full(value) -> str:
    """Raw piece-id symbol."""
    if value == 0:
        return "- "
    if value > 0:
        return f"+{int(value)}"
    return f"{int(value)}"


_TOP = " " * 7 + "|" + " " * 7 + "|" + " " * 7
_BOTTOM = "_" * 7 + "|" + "_" * 7 + "|" + "_" * 7


def _row(b, c0, c1, c2) -> str:
    return f"  {b[c0]}   " + "|" + f"   {b[c1]}  " + "|" + f"   {b[c2]}  "


def header_line(turn, agent_selection, action, piece) -> str:
    pos = action % 9
    return (
        f"TURN: {turn}, AGENT: {agent_selection}, ACTION: {action}, "
        f"POSITION: {pos}, PIECE: {piece}"
    )


def render_text_lines(flatboard, turn, agent_selection, action) -> list[str]:
    """'text' mode: the 3x3 top-piece view."""
    piece = ((action // 9) + 1 + 1) // 2
    b = list(map(_symbol, np.asarray(flatboard)))
    return [
        header_line(turn, agent_selection, action, piece),
        _TOP, _row(b, 0, 3, 6), _BOTTOM,
        _TOP, _row(b, 1, 4, 7), _BOTTOM,
        _TOP, _row(b, 2, 5, 8), _TOP,
        "",
    ]


def render_text_full_lines(squares, turn, agent_selection, action) -> list[str]:
    """'text_full' mode: all three levels side by side."""
    piece = (action // 9) + 1
    b = list(map(_symbol_full, np.asarray(squares).flatten()))
    head = (
        " " * 9 + "SMALL" + " " * 9 + "  "
        + " " * 10 + "MED" + " " * 10 + "  "
        + " " * 9 + "LARGE" + " " * 9 + "  "
    )
    lines = [header_line(turn, agent_selection, action, piece), head]
    triple_top = _TOP + "  " + _TOP + "  " + _TOP
    triple_bottom = _BOTTOM + "  " + _BOTTOM + "  " + _BOTTOM
    for cell, closing in ((0, triple_bottom), (1, triple_bottom), (2, triple_top)):
        body = (
            _row(b, cell, cell + 3, cell + 6) + "  "
            + _row(b, 9 + cell, 9 + cell + 3, 9 + cell + 6) + "  "
            + _row(b, 18 + cell, 18 + cell + 3, 18 + cell + 6)
        )
        lines += [triple_top, body, closing]
    lines.append("")
    return lines


def print_lines(lines) -> None:
    for line in lines:
        print(line)
