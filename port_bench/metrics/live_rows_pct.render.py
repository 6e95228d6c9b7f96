"""The share of the wavefront's rows alive as they enter a bounce, over
the window's bounces: 100 x the program's counter `rows.alive_in` over
`rows.bounce_in`. The integrator keeps every row of the wavefront to the
last bounce (no compaction), and K1/K4 draw for all of them; compaction
would raise this share. Nothing where the program has no counters."""

from port_bench.harness.program import live_rows_pct, snapshot


def read(tr):
    snap = snapshot()
    return None if snap is None else live_rows_pct(snap.counters)
