"""The routed K4 draw (`csrc/fused_sph.cu::sph_draw_routed_kernel`): the
work of the rows it drew (the program's counter `rows.routed_draw`; the
padding slots are not counted) over its device time, as a share of the
roofline. Nothing where the program has no such kernel or counter."""

from port_bench.harness.program import snapshot
from port_bench.harness.routed import routed_roofline_pct

FRAGMENT = "sph_draw_routed_kernel"


def read(tr):
    return routed_roofline_pct(tr, snapshot(), "sph_draw_routed", "rows.routed_draw", FRAGMENT)
