"""The benchmark's CPU tests. Tests that need the CUDA card carry the
``cuda`` marker and skip without one (``-m cuda`` on the card)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA GPU (skips without one); run with -m cuda on the card"
    )
