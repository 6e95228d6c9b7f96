"""The device's idle share of the render window spent while the host was
inside a bounce: window seconds of idle gaps whose midpoint falls in a
`render.bounce` span of the program or a span under it (the nine
`bounce.*` stages, the sampler's draws and pdf queries), over the window.
Read from the device trace and the program's own spans, aligned to it
(`harness/program.py`); nothing where the program has no spans."""

from port_bench.harness.program import idle_split


def read(tr):
    split = idle_split(tr)
    return None if split is None else split["in_bounce_pct"]
