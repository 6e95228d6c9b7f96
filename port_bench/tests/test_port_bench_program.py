"""The program's spans against the device trace, on synthetic events: the
buffer's alignment onto the trace's clock, the idle gaps it names, and the
three metrics that read the program's spans and counters."""

import sys
from typing import NamedTuple

import pytest

from port_bench.harness import program
from port_bench.harness.shares import idle_pct
from port_bench.harness.trace import Trace
from port_bench.run import read_metrics

BASE_NS = 1_790_000_000_000_000_000  # the buffer's time.time_ns() clock
OFFSET_US = 5_000.0  # where the buffer's first `render` start lies on the trace's clock
DELAYS_US = (20.0, 24.0)  # the driver's work between `render_call` and `render()`, a call
METRICS = ("idle_in_bounce_pct.render", "idle_outside_bounce_pct.render", "live_rows_pct.render")


class Span(NamedTuple):  # the fields `core/trace.py::Span` has
    index: int
    name: str
    start_ns: int
    end_ns: int
    parent: int
    root: int
    attrs: dict


class Snapshot(NamedTuple):
    spans: list
    counters: dict


def program_spans(delays=DELAYS_US):
    """Two render() calls of 1 s, each one pass: camera 0-0.1 s, one bounce
    0.1-0.8 s (its closest_hit stage 0.1-0.5 s, update 0.5-0.8 s), film
    0.8-0.9 s, finish 0.9-0.99 s, on the buffer's clock; call k starts
    2 s x k after the first plus its driver delay's change."""
    spans = []
    for k, d in enumerate(delays):
        t0 = BASE_NS + int(2e9 * k + (d - delays[0]) * 1e3)
        i = len(spans)
        rows = [("render", -1, 0.0, 0.99), ("render.pass", i, 0.0, 0.9), ("render.camera", i + 1, 0.0, 0.1),
                ("render.bounce", i + 1, 0.1, 0.8), ("bounce.closest_hit", i + 3, 0.1, 0.5),
                ("bounce.update", i + 3, 0.5, 0.8), ("render.film", i + 1, 0.8, 0.9), ("render.finish", i, 0.9, 0.99)]
        for j, (name, parent, a, b) in enumerate(rows):
            spans.append(Span(i + j, name, t0 + int(a * 1e9), t0 + int(b * 1e9), parent, i, {}))
    return spans


def device_trace(delays=DELAYS_US):
    """The harness's `render_call` spans (1 s each, 2 s apart, the first
    call's `render` at OFFSET_US) and device work that leaves idle, in the
    first call, 0.2-0.3 s (closest_hit), 0.85-0.87 s (film), 0.995-0.999 s
    (after `render`, inside `render_call`); in the second, 0.6-0.7 s
    (update) and 0.95-0.97 s (finish)."""
    c0 = OFFSET_US - delays[0]
    calls = [("render_call", c0, c0 + 1e6 + 100), ("render_call", c0 + 2e6, c0 + 3e6 + 100)]
    ms = 1e3
    busy = [(0, 200), (300, 850), (870, 995), (999, 2000), (2000, 2600), (2700, 2950), (2970, 3000.1)]
    ops = [("k", c0 + a * ms, c0 + b * ms) for a, b in busy]
    return Trace(ops=ops, spans=calls)


@pytest.mark.parametrize("delays", [(0.0, 0.0), DELAYS_US])
def test_alignment_recovers_the_offset(delays):
    """Every span lands where the trace's clock has it, less the median of
    the driver's delays (which the alignment cannot tell from the clocks'
    offset)."""
    spans = program_spans(delays)
    aligned, spread = program.align(device_trace(delays), spans)
    assert spread == pytest.approx(delays[1] - delays[0])
    shift = (delays[0] + delays[1]) / 2
    assert len(aligned) == len(spans)
    for (name, start, end, _), s in zip(aligned, spans):
        assert name == s.name
        assert start == pytest.approx(OFFSET_US + (s.start_ns - BASE_NS) * 1e-3 - shift, abs=1e-3)
        assert end == pytest.approx(OFFSET_US + (s.end_ns - BASE_NS) * 1e-3 - shift, abs=1e-3)
    assert {s[0] for s in aligned if s[3]} == {"render.bounce", "bounce.closest_hit", "bounce.update"}


def test_alignment_refuses_a_wide_spread():
    tr = device_trace()
    assert program.align(tr, program_spans(delays=(20.0, 20.0 + program.MAX_SPREAD_US + 1))) is None
    assert program.align(tr, program_spans()[:8]) is None  # one render span for two calls


def test_gaps_named_as_idle_gaps_names_them():
    tr = device_trace()
    aligned, _ = program.align(tr, program_spans())
    got = program.name_gaps(tr, aligned)
    want = Trace(tr.ops, tr.spans + [s[:3] for s in aligned]).idle_gaps()
    assert [(n, s) for n, s, _ in got] == pytest.approx(want)
    assert [(n, inb) for n, _, inb in got] == [("bounce.closest_hit", True), ("render.film", False),
                                               ("render_call", False), ("bounce.update", True),
                                               ("render.finish", False)]


def test_idle_metrics_sum_to_idle_pct(monkeypatch):
    tr = device_trace()
    monkeypatch.setattr(program, "snapshot", lambda: Snapshot(program_spans(), {}))
    got = read_metrics(METRICS[:2], tr)
    assert got[METRICS[0]] == pytest.approx(100 * 0.2 / tr.window_s, rel=1e-3)  # closest_hit, update
    assert got[METRICS[0]] + got[METRICS[1]] == pytest.approx(idle_pct(tr))


def test_live_rows_reads_the_counters(monkeypatch):
    monkeypatch.setattr(program, "snapshot",
                        lambda: Snapshot([], {"rows.bounce_in": 4 * 2 ** 20, "rows.alive_in": 2 ** 20}))
    assert read_metrics(METRICS[2:], device_trace()) == {METRICS[2]: pytest.approx(25.0)}


def test_a_program_without_spans_reads_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, "bsdf_diffusion_sampling_tpu_torch.core.trace", None)  # no trace module
    assert program.snapshot() is None
    assert read_metrics(METRICS, device_trace()) == {}
    monkeypatch.undo()
    monkeypatch.setattr(program, "snapshot", lambda: Snapshot([], {}))
    assert read_metrics(METRICS, device_trace()) == {}
