"""On the card: every cell's run end to end, a short window, `correct`
true and the import guard passed. Skips without a card."""

import json
import os
import subprocess
import sys

import pytest

from port_bench.run import ROOT


def cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("workload", cells())
def test_cell_runs_correct_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs the NVIDIA card")
    p = subprocess.run([sys.executable, "port_bench/run.py", "--workload", workload, "--seed", "2147483901",
                        "--seconds", "2", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
