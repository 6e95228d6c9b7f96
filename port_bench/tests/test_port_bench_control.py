"""The comparison that decides `correct`, on the CPU at a size a test run
holds: a sound run passes; the control (the reference in lower precision
in the program's place) and each fault the cell can have, planted in the
program underneath the driver, come out not correct. On the card, the
same through `port_bench/readings.py` at the cells' own sizes."""

import json
import os
import tempfile

import pytest
import torch

from port_bench.faults import FAULTS, planted
from port_bench.run import BENCH, load_cell

CPU = torch.device("cpu")
SMALL = {"render": {"width": 32, "height": 24, "spp": 8, "spp_chunk": 4, "max_depth": 4},
         "rectify": {"batch_wi": 4, "num_samples": 256, "timestep": 16}}
SCENE = {"n_lat": 12, "n_lon": 16, "plane_g": 3, "env_res": [32, 64]}


def run_cell(workload: str, seed: int = 20241017, control: bool = False) -> list:
    wl, cfg, driver = load_cell(workload)
    cfg["scene"] = dict(cfg["scene"], **SCENE)
    drv = driver(cfg, dict(wl["traffic"], **SMALL[wl["driver"]]), seed, CPU, tempfile.mkdtemp())
    drv.limits = wl["limits"]
    drv.warmup()
    drv.call(0)
    drv.release()
    return drv.check(control=control)


def failed(readings) -> list:
    return [n for n, v, lim in readings if not v <= lim]


def cells():
    with open(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.parametrize("workload", cells())
def test_sound_run_is_correct(workload):
    assert failed(run_cell(workload)) == []


@pytest.mark.parametrize("workload", cells())
def test_control_is_not_correct(workload):
    assert failed(run_cell(workload, control=True))


@pytest.mark.parametrize("workload,fault", [(w, f) for w in cells() for f in FAULTS[load_cell(w)[0]["driver"]]])
def test_fault_is_not_correct(workload, fault):
    with planted(load_cell(workload)[0]["driver"], fault):
        assert failed(run_cell(workload))
