"""K3 in rectify (`csrc/fused_transport.cu`, the teacher's primal
transport of the pairs): its counted work over its device time, as a
share of the roofline."""

from port_bench.harness.shares import roofline_pct

FRAGMENT = "transport_kernel"


def read(tr):
    return roofline_pct(tr, "k3", FRAGMENT)
