"""The program's own spans and counters (the port's `core/trace.py`), read
from its in-memory buffer after a traced window and put on the device
trace's clock.

The buffer's clock is `time.time_ns()`; the trace's is the profiler's (us
from its base time): the two agree to tens of us. Each `render()` call's
outermost span `render` opens inside the harness's `render_call` span of
the same call, so the offset that maps the k-th `render` start onto the
k-th `render_call` start is the clocks' offset less the harness's own work
between the two, a few hundred us under the profiler on the H100's host,
more in a window's first call. The median over the window's calls aligns
the buffer, every span then early by about that work. Offsets that spread
by more than MAX_SPREAD_US mean the calls and the `render` spans do not
pair up (a wrong pairing moves them by a whole call), and nothing is read.

Each idle gap of the device is then named by the innermost span its
midpoint falls in, the rule of `Trace.idle_gaps()` over the harness's
spans and the aligned program spans together, by one sweep over the
nested spans (the per-gap scan of every span that `idle_gaps` makes would
take ~1e5 gaps times ~1e4 spans in a disk window).

A program without the trace module, or a window without `render` spans,
reads nothing: the metrics that use this module then report nothing.
"""

from __future__ import annotations

import importlib
import statistics

MAX_SPREAD_US = 1000.0  # the harness's work before render() spread 41-374 us over a window's calls
BOUNCE = "render.bounce"


def snapshot():
    """The program's spans and counters, or None where the program has no
    trace module."""
    try:
        trace = importlib.import_module("bsdf_diffusion_sampling_tpu_torch.core.trace")
    except ImportError:
        return None
    return trace.snapshot()


def align(tr, spans):
    """([(name, start_us, end_us, in_bounce)] of the spans under each
    outermost `render` span, on `tr`'s clock, and the offsets' spread in us),
    or None where the calls and the roots do not pair up or the offsets
    spread by more than MAX_SPREAD_US. `in_bounce`: the span is
    `render.bounce` or lies under one."""
    calls = sorted(s[1] for s in tr.spans if s[0].endswith("_call"))
    roots = sorted((s for s in spans if s.name == "render" and s.parent < 0), key=lambda s: s.start_ns)
    if not roots or len(roots) != len(calls):
        return None
    base = roots[0].start_ns
    offsets = [c - (r.start_ns - base) * 1e-3 for c, r in zip(calls, roots)]
    spread = max(offsets) - min(offsets)
    if spread > MAX_SPREAD_US:
        return None
    off = statistics.median(offsets)
    ids = {r.index for r in roots}
    inb: dict = {}
    out = []
    for s in sorted(spans, key=lambda s: s.index):  # a parent opens before its children
        if s.root not in ids:
            continue
        inb[s.index] = s.name == BOUNCE or inb.get(s.parent, False)
        out.append((s.name, (s.start_ns - base) * 1e-3 + off, (s.end_ns - base) * 1e-3 + off, inb[s.index]))
    return out, spread


def name_gaps(tr, aligned) -> list:
    """[(name, seconds, in_bounce)] of the window's idle gaps: each named by
    the innermost aligned span holding its midpoint, else by the
    innermost harness span (else "harness"), as `Trace.idle_gaps()` names
    them over both span sets."""
    a, b = tr.window
    iv = tr.busy_intervals()
    edges = [a] + [x for s, e in iv for x in (s, e)] + [b]
    gaps = sorted(((0.5 * (s + e), e - s) for s, e in zip(edges[0::2], edges[1::2]) if e > s))
    order = sorted(aligned, key=lambda sp: (sp[1], -sp[2]))
    stack, j, out = [], 0, []
    for mid, dur in gaps:
        while j < len(order) and order[j][1] <= mid:
            while stack and stack[-1][2] < order[j][1]:
                stack.pop()
            stack.append(order[j])
            j += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        if stack:
            out.append((stack[-1][0], dur * 1e-6, stack[-1][3]))
            continue
        inside = [sp for sp in tr.spans if sp[1] <= mid <= sp[2]]
        name = min(inside, key=lambda sp: sp[2] - sp[1])[0] if inside else "harness"
        out.append((name, dur * 1e-6, False))
    return out


def idle_split(tr):
    """{"in_bounce_pct", "outside_bounce_pct", "by_name" (idle seconds by
    span name), "spread_us"} of the window, or None where the program's
    spans cannot be read or aligned. Computed once a trace."""
    if not hasattr(tr, "_program_idle"):
        tr._program_idle = None
        snap = snapshot()
        got = align(tr, snap.spans) if snap is not None else None
        if got is not None and tr.window_s > 0:
            aligned, spread = got
            gaps = name_gaps(tr, aligned)
            by_name: dict = {}
            for name, s, _ in gaps:
                by_name[name] = by_name.get(name, 0.0) + s
            inside = sum(s for _, s, inb in gaps if inb)
            outside = sum(s for _, s, inb in gaps if not inb)
            tr._program_idle = {"in_bounce_pct": 100.0 * inside / tr.window_s,
                                "outside_bounce_pct": 100.0 * outside / tr.window_s,
                                "by_name": by_name, "spread_us": spread}
    return tr._program_idle


def live_rows_pct(counters):
    """100 x the wavefront's live rows over its rows, summed over the
    window's bounces; None without the counters."""
    rows = (counters or {}).get("rows.bounce_in")
    if not rows or "rows.alive_in" not in counters:
        return None
    return 100.0 * counters["rows.alive_in"] / rows
