"""The benchmark's tests: CPU tests of the harness at tiny sizes (the
port's plain twins stand in for its kernels), and tests marked ``chip``
that need a CUDA card and skip without one."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card (skips without one)")
