"""K1 (the disk sampler's draw and pdf, `csrc/fused_ode.cu`): its counted
work over its device time, as a share of the roofline."""

from port_bench.harness.shares import roofline_pct

FRAGMENT = "sample_pdf_disk_kernel"


def read(tr):
    return roofline_pct(tr, "k1", FRAGMENT)
