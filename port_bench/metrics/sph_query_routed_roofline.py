"""The routed K2s query (`csrc/fused_sph.cu::sph_query_routed_kernel`):
the work of the rows it queried (the program's counter `rows.routed_pdf`;
the padding slots are not counted) over its device time, as a share of
the roofline. Nothing where the program has no such kernel or counter."""

from port_bench.harness.program import snapshot
from port_bench.harness.routed import routed_roofline_pct

FRAGMENT = "sph_query_routed_kernel"


def read(tr):
    return routed_roofline_pct(tr, snapshot(), "sph_query_routed", "rows.routed_pdf", FRAGMENT)
