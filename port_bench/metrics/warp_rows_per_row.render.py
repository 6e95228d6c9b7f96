"""The whole-wavefront warp evaluations one bounce costs a row: the rows
the envmap's and the measured BRDF's entry points computed (the program's
counters `rows.warp_env`, `rows.warp_brdf`) over the rows entering the
window's bounces (`rows.bounce_in`). Each entry point runs on every row of
the wavefront, so this is the number of such calls a bounce; compaction
would lower it. Nothing where the program has no such counters."""

from port_bench.harness.program import snapshot


def read(tr):
    snap = snapshot()
    c = {} if snap is None else snap.counters
    if not c.get("rows.bounce_in") or ("rows.warp_env" not in c and "rows.warp_brdf" not in c):
        return None
    return (c.get("rows.warp_env", 0) + c.get("rows.warp_brdf", 0)) / c["rows.bounce_in"]
