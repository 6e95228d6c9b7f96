"""The benchmark's own tests: `python -m pytest port_bench/tests -q` from
the repo root. Tests marked `chip` need the card and skip without one."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs the NVIDIA card; skips without one")
