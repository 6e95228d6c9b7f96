"""Operations and bytes the algorithm needs, from the cell's sizes alone:
what any implementation has to compute and move, not what one does.

Multiply-adds count two operations. The condition's part of a velocity
net's first layer is taken once a sample (it is constant over the steps);
the sigmoids and exps are not counted. A sample's pdf carries two tangent
streams beside the primal. Bytes are each input read once and each output
written once.
"""

from __future__ import annotations

COND = 22  # PE(omega_i, 5 bands) of a 2-vector
BASE_MACS = 14 * 16 + 16 * 4  # the base heads' 1 x 16 MLP over PE(omega_i, 3 bands)


def velocity_macs(hidden: int, layers: int, x_enc: int):
    """(primal, one tangent stream) multiply-adds of one velocity
    evaluation once the condition's part of layer 0 is taken."""
    deep = (layers - 1) * hidden * hidden + 2 * hidden
    return (x_enc + 1) * hidden + deep, x_enc * hidden + deep


def draw(n: int, hidden: int, layers: int, x_enc: int, T: int) -> dict:
    """A draw and its pdf (K1 disk, x_enc 2; K4 full sphere, x_enc 3): base
    heads, T steps of primal and two tangents. In: the condition and a
    seed; out: x, pdf, x0."""
    p, t = velocity_macs(hidden, layers, x_enc)
    macs = COND * hidden + BASE_MACS + T * (p + 2 * t)
    return {"flops": 2.0 * n * macs, "bytes": n * (4 * COND + 20)}


def transport(n: int, hidden: int, layers: int, x_enc: int, T: int, with_det: bool) -> dict:
    """T Euler steps of n points (K3): in x and the condition, out x (and
    the det)."""
    p, t = velocity_macs(hidden, layers, x_enc)
    macs = COND * hidden + T * (p + (2 * t if with_det else 0))
    return {"flops": 2.0 * n * macs, "bytes": n * (4 * COND + 16 + (4 if with_det else 0))}


def traversal(n_rays: int) -> dict:
    """Closest or any hit of n rays (K5), a byte bound only: in origin,
    direction, t_max and the active flag, out t, triangle, u, v. The tests
    a walk makes depend on the BVH, so none are counted."""
    return {"flops": 0.0, "bytes": n_rays * (28 + 1 + 16)}


def mlp_train(n: int, dims: list) -> dict:
    """Forward and backward of a bias-free MLP on n rows: three times the
    forward's multiply-adds."""
    macs = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    return {"flops": 6.0 * n * macs, "bytes": 0.0}


def add(*parts: dict) -> dict:
    return {"flops": sum(p["flops"] for p in parts), "bytes": sum(p["bytes"] for p in parts)}


def scale(part: dict, k: float) -> dict:
    return {"flops": part["flops"] * k, "bytes": part["bytes"] * k}
