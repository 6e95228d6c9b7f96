"""K4 (the spherical sampler's draw and pdf, `csrc/fused_sph.cu`): its
counted work over its device time, as a share of the roofline."""

from port_bench.harness.shares import roofline_pct

FRAGMENT = "sample_pdf_sph_kernel"


def read(tr):
    return roofline_pct(tr, "k4", FRAGMENT)
