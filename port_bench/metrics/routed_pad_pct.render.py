"""The routed kernels' padding: 100 x the slots that pad each ball's
segment to whole tiles (the program's counter `rows.routed_pad`) over
those slots and the routed rows (`rows.routed_draw`, `rows.routed_pdf`).
Nothing where the program has no such counters."""

from port_bench.harness.program import snapshot


def read(tr):
    snap = snapshot()
    c = {} if snap is None else snap.counters
    if "rows.routed_pad" not in c:
        return None
    pad = c["rows.routed_pad"]
    rows = c.get("rows.routed_draw", 0) + c.get("rows.routed_pdf", 0)
    return 100.0 * pad / (pad + rows) if pad + rows > 0 else None
