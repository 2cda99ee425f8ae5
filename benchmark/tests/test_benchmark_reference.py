"""The plain reference stands apart from the program: it imports nothing of
``gobblet_rl_torch``, JAX or the JAX package, and its rules agree with
hand-worked positions."""

import ast
import subprocess
import sys
from pathlib import Path

import torch

from benchmark.reference import opponents, rules

REPO = Path(__file__).resolve().parents[2]
FORBIDDEN = ("gobblet_rl_torch", "gobblet_rl_tpu", "jax", "jaxlib", "flax")


def test_reference_sources_import_nothing_of_the_program():
    for path in (REPO / "benchmark" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, f"{path.name} imports {name}"


def test_reference_loads_no_program_module():
    code = ("import sys; import benchmark.reference.rules, benchmark.reference.opponents, "
            "benchmark.reference.qnet, benchmark.reference.transitions; "
            f"print(sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]"


def _board(cells):
    """A board from {(level, cell): piece id}."""
    b = torch.zeros((1, 3, 9), dtype=torch.int8)
    for (level, cell), piece in cells.items():
        b[0, level, cell] = piece
    return b


def test_rules_on_worked_positions():
    empty = _board({})
    zero = torch.zeros(1, dtype=torch.int32)
    assert int(rules.legal_mask(empty, zero).sum()) == 54
    # player 0's small pieces on cells 0 and 1; a third on cell 2 completes a line
    b = _board({(0, 0): 1, (0, 1): 2, (1, 3): -3})
    after = rules.apply(b, zero, torch.tensor([2 * 9 + 2]))   # piece 3 (medium) to cell 2
    assert int(rules.winner(after)) == 1
    # a covered piece cannot move; a small piece cannot gobble a medium one
    covered = _board({(0, 4): 1, (1, 4): -3})
    legal = rules.legal_mask(covered, zero)[0]
    assert not legal[0 * 9 + 0] and not legal[0 * 9 + 4] and legal[1 * 9 + 0]
    assert rules.observation(b, zero).shape == (1, 3, 3, 13)


def test_greedy_takes_the_lowest_win_and_blocks():
    zero = torch.zeros(1, dtype=torch.int32)
    b = _board({(0, 0): 1, (0, 1): 2, (0, 6): -1, (0, 7): -2})
    allowed = opponents.allowed("greedy", b, zero, 2)[0]
    wins = [a for a in range(54) if allowed[a]]
    assert len(wins) == 1 and wins[0] % 9 == 2
    one = torch.ones(1, dtype=torch.int32)
    b = _board({(0, 0): 1, (0, 1): 2, (0, 6): -1})
    allowed = opponents.allowed("greedy", b, one, 2)[0]
    # player 1 must stop the line 0-1-2: every allowed move covers cell 2 or
    # gobbles a piece of the line
    for a in torch.nonzero(allowed)[:, 0].tolist():
        after = rules.apply(b, one, torch.tensor([a]))
        reply = opponents.allowed("greedy", after, zero, 1)[0]
        wins = [r for r in torch.nonzero(reply)[:, 0].tolist()
                if int(rules.winner(rules.apply(after, zero, torch.tensor([r])))) == 1]
        assert not wins
