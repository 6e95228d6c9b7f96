"""The share of the wavefront's rows that the full-sphere sampler's exact
pdf queries compute: 100 x the rows the routed K2s queried (the program's
counter `rows.routed_pdf`, padding excluded) over two queries a bounce on
every row entering it (2 x `rows.bounce_in`). Nothing where the program
has no such counters."""

from port_bench.harness.program import snapshot


def read(tr):
    snap = snapshot()
    c = {} if snap is None else snap.counters
    if "rows.routed_pdf" not in c or not c.get("rows.bounce_in"):
        return None
    return 100.0 * c["rows.routed_pdf"] / (2 * c["rows.bounce_in"])
