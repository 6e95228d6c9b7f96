"""The training iterations' share of the TF32 peak: the teacher's
transport of every pair and the student's forward and backward, over the
window's seconds."""

from port_bench.harness.shares import mfu_pct


def read(tr):
    return mfu_pct(tr, "step")
