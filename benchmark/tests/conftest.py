"""The benchmark's tests: ``python -m pytest benchmark/tests -q``.  Tests
that need a CUDA card carry the ``card`` marker and skip, from inside the
test, where there is none."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
