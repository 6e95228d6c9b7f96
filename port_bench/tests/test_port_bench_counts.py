"""The frozen counts against hand counts."""

import pytest

from port_bench.counts import work
from port_bench.harness.shares import roofline_pct
from port_bench.harness.trace import Trace

N = 1 << 20


def test_k1_disk_draw():
    # base heads 14x16 + 16x4 = 288; condition part 22 x 32 = 704; a step:
    # primal 3*32 + 2*32*32 + 2*32 = 2208, tangents 2 * (2*32 + 2048 + 64)
    macs = 288 + 704 + 4 * (2208 + 2 * 2176)
    assert macs == 27232
    assert work.draw(N, 32, 3, 2, 4) == {"flops": 2.0 * N * macs, "bytes": N * (88 + 20)}


def test_k4_sphere_draw():
    macs = 288 + 704 + 8 * ((4 * 32 + 3 * 1024 + 64) + 2 * (3 * 32 + 3 * 1024 + 64))
    assert macs == 78816
    assert work.draw(N, 32, 4, 3, 8)["flops"] == 2.0 * N * macs


@pytest.mark.parametrize("hidden,layers,T,det,macs", [
    (32, 4, 8, True, 704 + 8 * (3264 + 2 * 3232)),  # the render's reverse pdf with its det
    (64, 6, 256, False, 1408 + 256 * (4 * 64 + 5 * 64 * 64 + 128)),  # the 6 x 64 teacher's primal
])
def test_k3_transport(hidden, layers, T, det, macs):
    got = work.transport(1 << 22, hidden, layers, 3, T, det)
    assert got["flops"] == 2.0 * (1 << 22) * macs
    assert got["bytes"] == (1 << 22) * (88 + 16 + (4 if det else 0))


def test_teacher_iteration_is_4_5e13():
    assert abs(work.transport(1 << 22, 64, 6, 3, 256, False)["flops"] - 4.48e13) < 0.01e13


def test_k5_bytes():
    assert work.traversal(N) == {"flops": 0.0, "bytes": N * 45}


def test_roofline_never_over_a_kernel_at_the_bound():
    # 1 s of K1 at exactly its TF32 bound reads 100%
    w = work.draw(N, 32, 3, 2, 4)
    t = w["flops"] / 495e12 * 1e6
    tr = Trace(ops=[("sample_pdf_disk_kernel<3>", 0.0, t)], spans=[("render_call", 0.0, t)], work={"k1": w})
    assert roofline_pct(tr, "k1", "sample_pdf_disk_kernel") == pytest.approx(100.0)
