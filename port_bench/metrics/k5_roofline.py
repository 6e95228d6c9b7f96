"""K5 (the 8-wide BVH walk, `csrc/traverse8.cu`): the rays' bytes in and
hits out over its device time, as a share of the bandwidth roofline."""

from port_bench.harness.shares import roofline_pct

FRAGMENT = "traverse8_kernel"


def read(tr):
    return roofline_pct(tr, "k5", FRAGMENT)
