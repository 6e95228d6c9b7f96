"""The comparison that decides `correct` in the array cells of
`drivers/render_scene.py`, on the CPU at a size a test run holds: each
routed tile given the next ball's weights comes out not correct.
`test_port_bench_control.py` holds every cell of the driver, the array's
and the gt render's, to its sound run, its control and the faults of
`scene_faults.COMMON` (`port_bench/conftest.py` gives it the driver)."""

import pytest

from port_bench.run import load_cell
from port_bench.scene_faults import planted
from test_port_bench_control import cells, failed, run_cell


def array_cells():
    return [w for w in cells() if load_cell(w)[0]["driver"] == "render_scene" and "balls" in load_cell(w)[1]]


@pytest.mark.parametrize("workload", array_cells())
def test_next_balls_weights_is_not_correct(workload):
    with planted("next_balls_weights"):
        assert failed(run_cell(workload))
