"""BENCHMARK.json against the contract's shapes, and every cell's files
found by name."""

import json
import os
import re

import pytest

from port_bench.run import BENCH, ROOT, load_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == KEYS
    assert bench["paths"] == ["port_bench"]
    assert bench["command"] == ["python3", "port_bench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51


def test_names_and_units(bench):
    names = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[key]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((key, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    for wl in bench["workloads"]:
        assert NAME.match(wl["config"]) and NAME.match(wl["traffic"])
        assert wl["chips"] in (1, 4) and 1 <= len(wl["why"]) <= 200
    for cfg in bench["configs"]:
        assert all(NAME.match(k) for k in cfg["reduced"])
    assert len({n for _, n in names if _ in ("end_to_end", "per_layer")}) == \
        len(bench["end_to_end"]) + len(bench["per_layer"])


def test_metric_entries(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        reported = [e for e in bench["end_to_end"] if e["name"] == m["moves"]][0]
        assert set(m["workloads"]) <= set(reported.get("workloads", cells))


@pytest.mark.parametrize("kind", ["configs", "drivers", "metrics", "workloads"])
def test_files_found_by_name(bench, kind):
    if kind == "configs":
        for cfg in bench["configs"]:
            assert os.path.exists(os.path.join(ROOT, cfg["file"]))
            with open(os.path.join(ROOT, cfg["file"])) as f:
                assert json.load(f)["reduced"] == cfg["reduced"]
    elif kind == "metrics":
        for m in bench["per_layer"]:
            assert os.path.exists(os.path.join(BENCH, "metrics", m["name"] + ".py"))
    else:
        for w in bench["workloads"]:
            wl, cfg, driver = load_cell(w["name"])
            assert wl["config"] == w["config"] == cfg["name"] and wl["traffic_name"] == w["traffic"]
            assert wl["chips"] == w["chips"] and wl["why"] == w["why"]
            assert callable(driver)
