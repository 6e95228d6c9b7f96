"""Conditional piecewise-bilinear 2D warp: eval / sample / invert,
counterpart of the JAX package's `bsdf/marginal2d.py` (its generic path).

A distribution over the unit square is stored as vertex values of a
bilinear interpolant on an (H, W) grid, one grid per conditioning-parameter
slice (the theta_i incidence angles of an RGL file). Sampling draws the y
(row) coordinate from the marginal distribution, then x from the
conditional row density; `invert` is the exact inverse map. CDFs are
linear in the density, so slices are blended with one weight.

Cell lookups are binary searches over gathered scalars, O(N log W). The
JAX package's `_fast` / `_wide1` variants and its row-pair packing compute
the same functions with TPU-friendly row gathers and are not carried over.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch


class Warp2D(NamedTuple):
    """Per-parameter-slice normalized bilinear densities + CDF tables.

    density:  (P, H, W) vertex densities, trapezoid-integrating to 1
    cond_cdf: (P, H, W) cumulative trapezoid along x (cond_cdf[..., 0] = 0)
    marg_cdf: (P, H)    cumulative trapezoid along y of row integrals
    params:   (P,)      conditioning values (theta_i), increasing
    """

    density: torch.Tensor
    cond_cdf: torch.Tensor
    marg_cdf: torch.Tensor
    params: torch.Tensor

    @property
    def res(self) -> Tuple[int, int]:
        return self.density.shape[-2], self.density.shape[-1]

    def to(self, device) -> "Warp2D":
        return Warp2D(*(t.to(device) for t in self))


def build_warp2d(grids: np.ndarray, params: np.ndarray) -> Warp2D:
    """grids: (P, H, W) nonnegative vertex values; params: (P,) increasing.
    Built in float64 on the host, stored as float32 CPU tensors."""
    g = np.maximum(np.asarray(grids, np.float64), 0.0)
    P, H, W = g.shape
    dx, dy = 1.0 / (W - 1), 1.0 / (H - 1)
    seg_x = 0.5 * (g[..., :-1] + g[..., 1:]) * dx
    cond = np.concatenate([np.zeros((P, H, 1)), np.cumsum(seg_x, axis=-1)], axis=-1)
    row_int = cond[..., -1]
    seg_y = 0.5 * (row_int[:, :-1] + row_int[:, 1:]) * dy
    marg = np.concatenate([np.zeros((P, 1)), np.cumsum(seg_y, axis=-1)], axis=-1)
    total = np.maximum(marg[:, -1:], 1e-30)

    def f32(x):
        return torch.from_numpy(np.asarray(x, np.float32))

    return Warp2D(density=f32(g / total[..., None]), cond_cdf=f32(cond / total[..., None]),
                  marg_cdf=f32(marg / total), params=f32(params))


def bracket(grid: torch.Tensor, v: torch.Tensor):
    """Bracketing index + weight on a 1-D increasing grid, end-clamped."""
    n = grid.shape[0]
    if n == 1:
        return torch.zeros(v.shape, dtype=torch.int64, device=v.device), torch.zeros_like(v)
    idx = torch.clamp(torch.searchsorted(grid, v.contiguous(), right=True) - 1, 0, n - 2)
    w = torch.clamp((v - grid[idx]) / torch.clamp(grid[idx + 1] - grid[idx], min=1e-12), 0.0, 1.0)
    return idx, w


def _slices(warp: Warp2D, theta):
    p0, wp = bracket(warp.params, theta)
    return p0, torch.clamp(p0 + 1, max=warp.params.shape[0] - 1), wp


def _bsearch(cdf_at, n: int, target):
    """Largest cell index i in [0, n-2] with cdf(i) <= target (vectorized)."""
    lo = torch.zeros(target.shape, dtype=torch.int64, device=target.device)
    hi = torch.full_like(lo, n - 2)
    for _ in range(int(math.ceil(math.log2(max(n, 2))))):
        mid = torch.div(lo + hi + 1, 2, rounding_mode="floor")
        go_right = cdf_at(mid) <= target
        lo = torch.where(go_right, mid, lo)
        hi = torch.where(go_right, hi, mid - 1)
    return lo


def _invert_linear_cdf(c0, d0, d1, step, target):
    """Solve target = c0 + step*(d0*t + (d1-d0)*t^2/2) for t in [0,1] with
    the cancellation-free root t = 2*rhs / (d0 + sqrt(d0^2 + 2a*rhs))."""
    a = d1 - d0
    rhs = torch.clamp((target - c0) / step, min=0.0)
    disc = torch.clamp(d0 * d0 + 2.0 * a * rhs, min=0.0)
    t = 2.0 * rhs / torch.clamp(d0 + torch.sqrt(disc), min=1e-20)
    return torch.clamp(t, 0.0, 1.0)


def _eval_linear_cdf(c0, d0, d1, step, t):
    return c0 + step * (d0 * t + 0.5 * (d1 - d0) * t * t)


def _at(table, p, k, j=None):
    """table[p, k(, j)] with k and j clamped to the table, as a JAX gather
    clamps them: at the top edge a cell index can round up to the last
    vertex, and its `+ 1` neighbour then carries weight 0."""
    k = torch.clamp(k, max=table.shape[1] - 1)
    if j is None:
        return table[p, k]
    return table[p, k, torch.clamp(j, max=table.shape[2] - 1)]


def _marg(warp, p0, p1, wp, k):
    return (1 - wp) * _at(warp.marg_cdf, p0, k) + wp * _at(warp.marg_cdf, p1, k)


def _cond(warp, p0, p1, wp, k0, k1, wk, j):
    v0 = (1 - wp) * _at(warp.cond_cdf, p0, k0, j) + wp * _at(warp.cond_cdf, p1, k0, j)
    v1 = (1 - wp) * _at(warp.cond_cdf, p0, k1, j) + wp * _at(warp.cond_cdf, p1, k1, j)
    return (1 - wk) * v0 + wk * v1


def _dens(warp, p0, p1, wp, k0, k1, wk, j):
    v0 = (1 - wp) * _at(warp.density, p0, k0, j) + wp * _at(warp.density, p1, k0, j)
    v1 = (1 - wp) * _at(warp.density, p0, k1, j) + wp * _at(warp.density, p1, k1, j)
    return (1 - wk) * v0 + wk * v1


def _row_density(warp, p0, p1, wp, k):
    """Marginal (row-integral) density at vertex row k."""
    last = torch.full_like(k, warp.cond_cdf.shape[2] - 1)
    return (1 - wp) * _at(warp.cond_cdf, p0, k, last) + wp * _at(warp.cond_cdf, p1, k, last)


def _cell(x, n: int):
    """(cell index, fraction) of unit coordinates x on n vertices."""
    xf = torch.clamp(x * (n - 1), 0.0, n - 1 - 1e-6)
    i = xf.to(torch.int64)
    return i, xf - i.to(xf.dtype)


def warp_sample(warp: Warp2D, u: torch.Tensor, theta: torch.Tensor):
    """u: (..., 2) uniforms; theta: (...,) parameter. Returns ((..., 2) pos,
    (...,) density at pos)."""
    H, W = warp.res
    dx, dy = 1.0 / (W - 1), 1.0 / (H - 1)
    u1, u2 = u[..., 0], u[..., 1]
    p0, p1, wp = _slices(warp, theta)

    k = _bsearch(lambda i: _marg(warp, p0, p1, wp, i), H, u2)
    m0 = _row_density(warp, p0, p1, wp, k)
    m1 = _row_density(warp, p0, p1, wp, k + 1)
    t = _invert_linear_cdf(_marg(warp, p0, p1, wp, k), m0, m1, dy, u2)
    y = (k.to(u2.dtype) + t) * dy

    target = u1 * ((1 - t) * m0 + t * m1)
    j = _bsearch(lambda i: _cond(warp, p0, p1, wp, k, k + 1, t, i), W, target)
    d0 = _dens(warp, p0, p1, wp, k, k + 1, t, j)
    d1 = _dens(warp, p0, p1, wp, k, k + 1, t, j + 1)
    s = _invert_linear_cdf(_cond(warp, p0, p1, wp, k, k + 1, t, j), d0, d1, dx, target)
    x = (j.to(u1.dtype) + s) * dx
    return torch.stack([x, y], dim=-1), (1 - s) * d0 + s * d1


def warp_invert(warp: Warp2D, pos: torch.Tensor, theta: torch.Tensor):
    """Exact inverse of warp_sample: (pos, theta) -> ((..., 2) u, density)."""
    H, W = warp.res
    dx, dy = 1.0 / (W - 1), 1.0 / (H - 1)
    p0, p1, wp = _slices(warp, theta)
    k, t = _cell(pos[..., 1], H)
    m0 = _row_density(warp, p0, p1, wp, k)
    m1 = _row_density(warp, p0, p1, wp, k + 1)
    u2 = _eval_linear_cdf(_marg(warp, p0, p1, wp, k), m0, m1, dy, t)
    j, s = _cell(pos[..., 0], W)
    d0 = _dens(warp, p0, p1, wp, k, k + 1, t, j)
    d1 = _dens(warp, p0, p1, wp, k, k + 1, t, j + 1)
    cx = _eval_linear_cdf(_cond(warp, p0, p1, wp, k, k + 1, t, j), d0, d1, dx, s)
    u1 = cx / torch.clamp((1 - t) * m0 + t * m1, min=1e-20)
    return torch.stack([u1, u2], dim=-1), (1 - s) * d0 + s * d1


def warp_eval(warp: Warp2D, pos: torch.Tensor, theta: torch.Tensor):
    """Normalized density at pos (unit-square measure)."""
    H, W = warp.res
    p0, p1, wp = _slices(warp, theta)
    k, t = _cell(pos[..., 1], H)
    j, s = _cell(pos[..., 0], W)
    d0 = _dens(warp, p0, p1, wp, k, k + 1, t, j)
    d1 = _dens(warp, p0, p1, wp, k, k + 1, t, j + 1)
    return (1 - s) * d0 + s * d1
