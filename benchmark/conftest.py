"""pytest settings of the benchmark's own tests (``benchmark/tests/``).

Tests that need a CUDA card carry the ``card`` marker; each decides inside
the test whether a card is there and skips on the CPU."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
