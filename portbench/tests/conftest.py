"""Tests of the benchmark harness, its reference and its yardstick. They
run on the CPU at tiny sizes (``python -m pytest portbench/tests``); a
test that needs the card carries the ``cuda`` marker and skips without
one."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")
