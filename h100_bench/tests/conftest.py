"""The benchmark's own tests (CPU, tiny sizes; ``cuda`` ones skip
without a card).  Run from the repository's root:

    python -m pytest h100_bench/tests -q -p no:cacheprovider
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips without one)")
