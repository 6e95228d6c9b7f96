"""The render passes' share of the TF32 peak: the sampler's counted
operations (one draw a ray-bounce, the pdf queries the matball asks for,
on every ray of the wavefront) over the window's seconds."""

from port_bench.harness.shares import mfu_pct


def read(tr):
    return mfu_pct(tr, "step")
