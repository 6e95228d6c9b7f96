"""The trace arithmetic on synthetic event lists."""

import pytest

from port_bench.harness.shares import idle_pct, mfu_pct, roofline_pct
from port_bench.harness.trace import Trace


def trace():
    # two calls of 1 s each, 10 us apart; device busy 0-0.5 s, 0.4-0.8 s
    # (overlapping), 1.2-1.7 s; idle 0.8-1.2 (in call 1 and call 2) and
    # 1.7-2.00001
    spans = [("render_call", 0.0, 1e6), ("render_call", 1e6 + 10, 2e6 + 10)]
    ops = [("k_a", 0.0, 5e5), ("traverse8_kernel", 4e5, 8e5), ("k_a", 1.2e6, 1.7e6), ("k_out", 3e6, 4e6)]
    return Trace(ops=ops, spans=spans)


def test_window_and_busy():
    tr = trace()
    assert tr.window_s == pytest.approx(2.00001)
    assert tr.busy_s == pytest.approx(1.3)
    assert idle_pct(tr) == pytest.approx(100 * (1 - 1.3 / 2.00001))


def test_gaps_named_by_span():
    gaps = sorted(trace().idle_gaps(), key=lambda g: -g[1])
    assert gaps[0][1] == pytest.approx(0.4)
    assert {g[0] for g in gaps} <= {"render_call", "harness"}


def test_device_time_by_fragment():
    tr = trace()
    assert tr.device_s(lambda n: "traverse8_kernel" in n) == pytest.approx(0.4)
    assert tr.device_s(lambda n: n == "k_out") == 0.0  # outside the window


def test_mfu_and_rate():
    tr = trace()
    tr.work = {"step": {"flops": 495e12 * 0.5, "bytes": 0.0}, "k5": {"flops": 0.0, "bytes": 3.35e12 * 0.1}}
    assert mfu_pct(tr) == pytest.approx(100 * 0.5 / 2.00001)
    assert roofline_pct(tr, "k5", "traverse8_kernel") == pytest.approx(25.0)
    assert roofline_pct(tr, "k1", "sample_pdf_disk_kernel") is None


def test_breakdown_lists_at_most_ten():
    tr = trace()
    tr.ops += [(f"k{i}", 1e5 * i, 1e5 * i + 1) for i in range(20)]
    b = tr.breakdown()
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    assert b["device_ops"][0][0] == "k_a"
