"""The arithmetic of the per-layer shares: a kernel's share of its
roofline, the window's share of the TF32 peak, the device's idle share."""

from __future__ import annotations

from port_bench.counts.peaks import HBM_BYTES, TF32_FLOPS


def roofline_pct(tr, key: str, fragment: str):
    """100 x the least time the counted work `tr.work[key]` could take on
    the device (operations at the TF32 peak or bytes at HBM bandwidth,
    whichever is longer) over the device time of the kernels whose names
    hold `fragment`. None where the window launched none of them."""
    work = tr.work.get(key)
    busy = tr.device_s(lambda name: fragment in name)
    if not work or busy <= 0.0:
        return None
    return 100.0 * max(work["flops"] / TF32_FLOPS, work["bytes"] / HBM_BYTES) / busy


def mfu_pct(tr, key: str = "step"):
    """100 x the counted operations of the window's calls over the window's
    seconds at the TF32 peak."""
    work = tr.work.get(key)
    if not work or tr.window_s <= 0.0:
        return None
    return 100.0 * work["flops"] / (tr.window_s * TF32_FLOPS)


def idle_pct(tr):
    return 100.0 * (1.0 - tr.busy_s / tr.window_s) if tr.window_s > 0 else None
