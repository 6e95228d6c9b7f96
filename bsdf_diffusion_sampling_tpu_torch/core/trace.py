"""Spans and counters of the port's render and rectify paths, on the
profiler's clock.

They record only while a `torch.profiler.profile` (or
`torch.autograd.profiler.profile`) session is running: `span` then opens a
`torch.profiler.record_function` of its name, so an exported Chrome trace
shows the spans nested beside the device's kernels, and keeps a record of
it in an in-memory ring (name, start and end from `time.time_ns()`, the
index of the enclosing span, the index of the outermost one, attributes).
The Chrome export writes a CPU event's `ts` as (unix ns -
`baseTimeNanoseconds`) / 1000, so the records share the trace's clock. With
no profiler running a span is one flag check that returns a shared no-op
object: no allocation, no torch call, no device sync.

Counters add up only while spans record. A value may be a host int or a
0-dim device tensor; device values are summed on the device and read once,
by `snapshot()`, which synchronizes.

Spans and counters are the process's own (one ring, one open-span stack):
the render and rectify paths run on one host thread. No span opens inside a
CUDA-graph capture: a captured region replays without its host code.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

CAPACITY = 1 << 20  # records the ring keeps; the oldest go first


class Span(NamedTuple):
    index: int  # order of opening, unique in the process
    name: str
    start_ns: int  # time.time_ns()
    end_ns: int
    parent: int  # index of the enclosing span; -1 for an outermost one
    root: int  # index of the outermost span: one render() call's or one training iteration's id
    attrs: dict


class Snapshot(NamedTuple):
    spans: list  # [Span] in order of opening
    counters: dict  # name -> int or float


if hasattr(_autograd_profiler, "_is_profiler_enabled"):
    def enabled() -> bool:
        """Is a profiler session recording on this process?"""
        return _autograd_profiler._is_profiler_enabled
else:  # pragma: no cover - older torch
    enabled = torch._C._autograd._profiler_enabled

_ring: deque = deque(maxlen=CAPACITY)
_open: list = []  # spans entered and not yet left, outermost first
_next = 0
_host_counts: dict = {}
_device_counts: dict = {}


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Mark:
    """No span, only the caller's `mark(name)` at the end of a stage."""

    __slots__ = ("mark", "name")

    def __init__(self, mark, name):
        self.mark, self.name = mark, name

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.mark(self.name)
        return False


class _Span:
    __slots__ = ("name", "attrs", "mark", "mark_name", "index", "parent", "root", "start", "rf")

    def __init__(self, name, attrs, mark=None, mark_name=None):
        self.name, self.attrs, self.mark, self.mark_name = name, attrs, mark, mark_name

    def __enter__(self):
        global _next
        self.index, _next = _next, _next + 1
        if _open:
            self.parent, self.root = _open[-1].index, _open[-1].root
        else:
            self.parent, self.root = -1, self.index
        _open.append(self)
        self.start = time.time_ns()
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        try:
            if self.mark is not None and exc_type is None:
                self.mark(self.mark_name)
        finally:
            self.rf.__exit__(exc_type, exc, tb)
            end = time.time_ns()
            _open.pop()
            _ring.append(Span(self.index, self.name, self.start, end, self.parent, self.root, self.attrs))
        return False


def span(name: str, **attrs):
    """A context manager: the span `name` with `attrs` (a bounce's `depth`,
    say) while a profiler records, else the shared no-op."""
    if not enabled():
        return _NOOP
    return _Span(name, attrs)


def stage(name: str, mark: Callable[[str], None] | None = None):
    """The span `name` around one stage of a sequence (`bounce.closest_hit`),
    which ends by calling `mark(<the name's last dotted part>)` where a
    caller gave one: the caller's marks come at the stage boundaries whether
    or not a profiler records."""
    if not enabled():
        return _NOOP if mark is None else _Mark(mark, name.rpartition(".")[2])
    return _Span(name, {}, mark, name.rpartition(".")[2])


def count(name: str, value) -> None:
    """Add `value` (a host int, or a 0-dim tensor summed where it lives) to
    the counter `name` while a profiler records."""
    if not enabled():
        return
    if isinstance(value, torch.Tensor):
        acc = _device_counts.get(name)
        if acc is None:
            _device_counts[name] = value.detach().clone()
        else:
            acc.add_(value.detach())
    else:
        _host_counts[name] = _host_counts.get(name, 0) + value


def snapshot() -> Snapshot:
    """The ring's closed spans in order of opening, and the counters (device
    ones read here, which synchronizes)."""
    counters = dict(_host_counts)
    for name, acc in _device_counts.items():
        counters[name] = counters.get(name, 0) + acc.item()
    return Snapshot(sorted(_ring, key=lambda s: s.index), counters)


def clear() -> None:
    """Empty the ring and the counters (spans still open close into the
    emptied ring)."""
    _ring.clear()
    _host_counts.clear()
    _device_counts.clear()


def summary() -> dict:
    """{"spans": {name: {"count", "total_ms", "self_ms"}}, "counters":
    {...}} over the ring: host milliseconds in each span name, and its self
    time, the duration less the time its child spans cover."""
    snap = snapshot()
    child_ns: dict = {}
    for s in snap.spans:
        if s.parent >= 0:
            child_ns[s.parent] = child_ns.get(s.parent, 0) + (s.end_ns - s.start_ns)
    out: dict = {}
    for s in snap.spans:
        row = out.setdefault(s.name, {"count": 0, "total_ms": 0.0, "self_ms": 0.0})
        dur = s.end_ns - s.start_ns
        row["count"] += 1
        row["total_ms"] += dur * 1e-6
        row["self_ms"] += (dur - child_ns.get(s.index, 0)) * 1e-6
    return {"spans": out, "counters": snap.counters}
