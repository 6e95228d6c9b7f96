"""The rest of the device's idle share of the render window: gaps whose
midpoint falls in the program's `render.camera`, `render.film`,
`render.finish`, `render.pass` or `render` spans outside any bounce, or
outside every program span (the harness between calls). With
`idle_in_bounce_pct.render` it sums to `device_idle_pct.render`. Nothing
where the program has no spans."""

from port_bench.harness.program import idle_split


def read(tr):
    split = idle_split(tr)
    return None if split is None else split["outside_bounce_pct"]
