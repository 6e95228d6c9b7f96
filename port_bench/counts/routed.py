"""Operations and bytes of the full-sphere sampler's exact pdf query (the
Newton inverse of the forward Euler map, as K2s and the routed query run
it), a row at a time: the counterpart of `work.py::draw` for the query.

Per row: the condition's part of layer 0 and the base heads once; then
for each of the T steps a primal evaluation (the reverse-Euler warm
start) and iters + 1 evaluations of the primal with both tangent streams
(the Newton updates, then the det at the converged point). In: the query
point (8 bytes) and the condition (88); out: the pdf and x0 (12).
"""

from __future__ import annotations

from port_bench.counts.work import BASE_MACS, COND, velocity_macs

QUERY_BYTES = 108


def query(n: int, hidden: int, layers: int, x_enc: int, T: int, iters: int) -> dict:
    p, t = velocity_macs(hidden, layers, x_enc)
    macs = COND * hidden + BASE_MACS + T * (p + (iters + 1) * (p + 2 * t))
    return {"flops": 2.0 * n * macs, "bytes": float(n * QUERY_BYTES)}
