"""K3 in a render (`csrc/fused_transport.cu`, the reverse transport with
its det that a pdf query runs): its counted work over its device time,
as a share of the roofline."""

from port_bench.harness.shares import roofline_pct

FRAGMENT = "transport_kernel"


def read(tr):
    return roofline_pct(tr, "k3", FRAGMENT)
