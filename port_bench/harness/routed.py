"""The routed kernels' share of their roofline: the work they did is known
only from the program's row counters, so the driver's count is one row's
(`work[key]`, with "rows": 1 a call) and the counter says how many rows
the window's launches computed."""

from __future__ import annotations

from port_bench.counts.peaks import HBM_BYTES, TF32_FLOPS


def routed_roofline_pct(tr, snap, key: str, counter: str, fragment: str):
    """100 x the least time the counted rows' work could take (operations
    at the TF32 peak or bytes at HBM bandwidth, whichever is longer) over
    the device time of the kernels whose names hold `fragment`. None where
    the program has no such counter or the window launched no such
    kernel."""
    per = tr.work.get(key)
    rows = None if snap is None else snap.counters.get(counter)
    busy = tr.device_s(lambda name: fragment in name)
    if not per or not per.get("rows") or not rows or busy <= 0.0:
        return None
    flops, nbytes = rows * per["flops"] / per["rows"], rows * per["bytes"] / per["rows"]
    return 100.0 * max(flops / TF32_FLOPS, nbytes / HBM_BYTES) / busy
