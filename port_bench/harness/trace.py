"""Reading a `torch.profiler` trace of the measured window: device
operations (kernels, copies, sets) and the harness's own host spans, from
the profiler's Chrome trace, and the arithmetic the per-layer metrics
share: the busy time as the union of device intervals, idle gaps named by
the host span they fall in, and device time by kernel-name fragment."""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Trace:
    ops: list  # (name, start_us, end_us) of device operations
    spans: list  # (name, start_us, end_us) of the harness's host spans
    work: dict = field(default_factory=dict)  # what the window's calls did, from the driver's counts

    @property
    def window(self):
        """(start, end) in us: the first timed call's start to the last's
        end (the calls' spans are named `*_call`)."""
        calls = [s for s in self.spans if s[0].endswith("_call")]
        return min(s[1] for s in calls), max(s[2] for s in calls)

    @property
    def window_s(self) -> float:
        a, b = self.window
        return (b - a) * 1e-6

    def busy_intervals(self) -> list:
        a, b = self.window
        iv = sorted((max(s, a), min(e, b)) for _, s, e in self.ops if e > a and s < b)
        out = []
        for s, e in iv:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def device_s(self, match) -> float:
        """Seconds of device operations whose name `match` accepts."""
        a, b = self.window
        return sum(e - s for n, s, e in self.ops if match(n) and s >= a and e <= b) * 1e-6

    def idle_gaps(self) -> list:
        """[(host span, seconds)] of the gaps between busy intervals, each
        named by the innermost harness span its midpoint falls in."""
        a, b = self.window
        iv = self.busy_intervals()
        edges = [a] + [x for s, e in iv for x in (s, e)] + [b]
        gaps = []
        for s, e in zip(edges[0::2], edges[1::2]):
            if e > s:
                mid = 0.5 * (s + e)
                inside = [sp for sp in self.spans if sp[1] <= mid <= sp[2]]
                name = min(inside, key=lambda sp: sp[2] - sp[1])[0] if inside else "harness"
                gaps.append((name, (e - s) * 1e-6))
        return gaps

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict = {}
        a, b = self.window
        for n, s, e in self.ops:
            if s >= a and e <= b:
                by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_gaps(), key=lambda g: -g[1])[:top]
        return {"device_ops": [[n[:200], s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}


def read_chrome_trace(path: str, span_names) -> Trace:
    with open(path) as f:
        events = json.load(f)
    events = events["traceEvents"] if isinstance(events, dict) else events
    ops, spans = [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, ts, dur = ev.get("cat", ""), float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            ops.append((ev.get("name", ""), ts, ts + dur))
        elif cat == "user_annotation" and ev.get("name") in span_names:
            spans.append((ev["name"], ts, ts + dur))
    return Trace(ops, spans)


def export_and_read(prof, span_names, directory: str) -> Trace:
    """The profiler's trace written under `directory`, read back and
    removed."""
    path = os.path.join(directory, f"port_bench_trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    try:
        return read_chrome_trace(path, span_names)
    finally:
        os.remove(path)
