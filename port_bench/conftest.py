"""The tests that key their sizes and faults by driver name
(`tests/test_port_bench_control.py`: `SMALL`, `faults.FAULTS`,
`faults.planted`) learn here of the drivers added after them:
`render_scene` takes `render`'s test sizes and `scene_faults.COMMON`.
Used by pytest alone; the benchmark's runs never load it."""

import contextlib
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from port_bench import faults, scene_faults  # noqa: E402

ADDED = {"render_scene": "render"}  # a driver added later -> the driver whose test sizes it takes

faults.FAULTS.setdefault("render_scene", scene_faults.COMMON)
_planted = faults.planted


@contextlib.contextmanager
def planted(driver: str, fault: str):
    with scene_faults.planted(fault) if driver == "render_scene" else _planted(driver, fault):
        yield


faults.planted = planted


@pytest.fixture(autouse=True)
def _added_drivers_sizes(request):
    """A test module's `SMALL` sizes by driver name gain the added drivers'."""
    small = getattr(request.module, "SMALL", None)
    if isinstance(small, dict):
        for added, like in ADDED.items():
            if like in small:
                small.setdefault(added, small[like])
