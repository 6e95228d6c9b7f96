"""The device's idle share of the render window: seconds in which no
device operation ran, over the window (first render call's start to the
last's end), from the profiler's trace."""

from port_bench.harness.shares import idle_pct


def read(tr):
    return idle_pct(tr)
