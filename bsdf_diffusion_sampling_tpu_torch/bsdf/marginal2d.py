"""Conditional piecewise-bilinear 2D warp: eval / sample / invert,
counterpart of the JAX package's `bsdf/marginal2d.py` (its generic path).

A distribution over the unit square is stored as vertex values of a
bilinear interpolant on an (H, W) grid, one grid per conditioning-parameter
slice (the theta_i incidence angles of an RGL file). Sampling draws the y
(row) coordinate from the marginal distribution, then x from the
conditional row density; `invert` is the exact inverse map. CDFs are
linear in the density, so slices are blended with one weight.

Anisotropic files condition on (phi_i, theta_i): their slices are flattened
phi-major (slice pf * Pt + tf) and blended bilinearly over the 4 bracketing
(phi, theta) slices, in the JAX package's order (`_slice_weights`).

Cell lookups are binary searches over gathered scalars, O(N log W). The
JAX package's `_fast` / `_wide1` variants and its row-pair packing compute
the same functions with TPU-friendly row gathers and are not carried over.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


class Warp2D(NamedTuple):
    """Per-parameter-slice normalized bilinear densities + CDF tables.

    density:  (P, H, W) vertex densities, trapezoid-integrating to 1
    cond_cdf: (P, H, W) cumulative trapezoid along x (cond_cdf[..., 0] = 0)
    marg_cdf: (P, H)    cumulative trapezoid along y of row integrals
    params:   (Pt,)     conditioning values (theta_i), increasing
    params_phi: (Pp,)   the phi_i grid of an anisotropic warp (P == Pp * Pt,
                        slice p = pf * Pt + tf), None for an isotropic one
    """

    density: torch.Tensor
    cond_cdf: torch.Tensor
    marg_cdf: torch.Tensor
    params: torch.Tensor
    params_phi: Optional[torch.Tensor] = None

    @property
    def res(self) -> Tuple[int, int]:
        return self.density.shape[-2], self.density.shape[-1]

    def to(self, device) -> "Warp2D":
        return Warp2D(*(None if t is None else t.to(device) for t in self))


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


def build_warp2d_aniso(grids: np.ndarray, theta: np.ndarray, phi: np.ndarray) -> Warp2D:
    """grids: (Pp, Pt, H, W) vertex values conditioned on (phi_i, theta_i);
    slices flattened phi-major."""
    Pp, Pt, H, W = grids.shape
    flat = build_warp2d(np.asarray(grids).reshape(Pp * Pt, H, W), np.tile(np.asarray(theta), Pp))
    return flat._replace(params=torch.from_numpy(np.asarray(theta, np.float32)),
                         params_phi=torch.from_numpy(np.asarray(phi, np.float32)))


def bracket(grid: torch.Tensor, v: torch.Tensor):
    """Bracketing index + weight on a 1-D increasing grid, end-clamped."""
    n = grid.shape[0]
    if n == 1:
        return torch.zeros(v.shape, dtype=torch.int64, device=v.device), torch.zeros_like(v)
    idx = torch.clamp(torch.searchsorted(grid, v.contiguous(), right=True) - 1, 0, n - 2)
    w = torch.clamp((v - grid[idx]) / torch.clamp(grid[idx + 1] - grid[idx], min=1e-12), 0.0, 1.0)
    return idx, w


def slice_weights(theta_grid: torch.Tensor, phi_grid: Optional[torch.Tensor], theta, phi=None):
    """[(flat slice index, weight)]: 2 entries on a theta-only grid, 4 on a
    (phi_i, theta_i) one, for each theta slice phi low then phi high;
    weights sum to 1. phi None on an anisotropic grid means phi 0."""
    Pt = theta_grid.shape[0]
    ti, tw = bracket(theta_grid, theta)
    t_slices = [(ti, 1.0 - tw), (torch.clamp(ti + 1, max=Pt - 1), tw)]
    if phi_grid is None or phi_grid.shape[0] <= 1:
        return t_slices
    Pp = phi_grid.shape[0]
    if phi is None:
        phi = torch.zeros_like(theta)
    pi_, pw = bracket(phi_grid, phi)
    out = []
    for t_idx, t_w in t_slices:
        out.append((pi_ * Pt + t_idx, (1.0 - pw) * t_w))
        out.append((torch.clamp(pi_ + 1, max=Pp - 1) * Pt + t_idx, pw * t_w))
    return out


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


def _blend(table, slices, k, j=None):
    """sum over the slice list of weight * table[slice, k(, j)], in the
    list's order."""
    out = None
    for p, w in slices:
        v = w * _at(table, p, k, j)
        out = v if out is None else out + v
    return out


def _marg(warp, slices, k):
    return _blend(warp.marg_cdf, slices, k)


def _cond(warp, slices, k0, k1, wk, j):
    return (1 - wk) * _blend(warp.cond_cdf, slices, k0, j) + wk * _blend(warp.cond_cdf, slices, k1, j)


def _dens(warp, slices, k0, k1, wk, j):
    return (1 - wk) * _blend(warp.density, slices, k0, j) + wk * _blend(warp.density, slices, k1, j)


def _row_density(warp, slices, k):
    """Marginal (row-integral) density at vertex row k."""
    return _blend(warp.cond_cdf, slices, k, torch.full_like(k, warp.cond_cdf.shape[2] - 1))


def _cell(x, n: int):
    """(cell index, fraction) of unit coordinates x on n vertices."""
    xf = torch.clamp(x * (n - 1), 0.0, n - 1 - 1e-6)
    i = xf.to(torch.int64)
    return i, xf - i.to(xf.dtype)


def warp_sample(warp: Warp2D, u: torch.Tensor, theta: torch.Tensor, phi=None):
    """u: (..., 2) uniforms; theta: (...,) parameter (and phi for an
    anisotropic warp). Returns ((..., 2) pos, (...,) density at pos)."""
    H, W = warp.res
    dx, dy = 1.0 / (W - 1), 1.0 / (H - 1)
    u1, u2 = u[..., 0], u[..., 1]
    sl = slice_weights(warp.params, warp.params_phi, theta, phi)

    k = _bsearch(lambda i: _marg(warp, sl, i), H, u2)
    m0 = _row_density(warp, sl, k)
    m1 = _row_density(warp, sl, k + 1)
    t = _invert_linear_cdf(_marg(warp, sl, k), m0, m1, dy, u2)
    y = (k.to(u2.dtype) + t) * dy

    target = u1 * ((1 - t) * m0 + t * m1)
    j = _bsearch(lambda i: _cond(warp, sl, k, k + 1, t, i), W, target)
    d0 = _dens(warp, sl, k, k + 1, t, j)
    d1 = _dens(warp, sl, k, k + 1, t, j + 1)
    s = _invert_linear_cdf(_cond(warp, sl, k, k + 1, t, j), d0, d1, dx, target)
    x = (j.to(u1.dtype) + s) * dx
    return torch.stack([x, y], dim=-1), (1 - s) * d0 + s * d1


def warp_invert(warp: Warp2D, pos: torch.Tensor, theta: torch.Tensor, phi=None):
    """Exact inverse of warp_sample: (pos, theta) -> ((..., 2) u, density)."""
    H, W = warp.res
    dx, dy = 1.0 / (W - 1), 1.0 / (H - 1)
    sl = slice_weights(warp.params, warp.params_phi, theta, phi)
    k, t = _cell(pos[..., 1], H)
    m0 = _row_density(warp, sl, k)
    m1 = _row_density(warp, sl, k + 1)
    u2 = _eval_linear_cdf(_marg(warp, sl, k), m0, m1, dy, t)
    j, s = _cell(pos[..., 0], W)
    d0 = _dens(warp, sl, k, k + 1, t, j)
    d1 = _dens(warp, sl, k, k + 1, t, j + 1)
    cx = _eval_linear_cdf(_cond(warp, sl, k, k + 1, t, j), d0, d1, dx, s)
    u1 = cx / torch.clamp((1 - t) * m0 + t * m1, min=1e-20)
    return torch.stack([u1, u2], dim=-1), (1 - s) * d0 + s * d1


def warp_eval(warp: Warp2D, pos: torch.Tensor, theta: torch.Tensor, phi=None):
    """Normalized density at pos (unit-square measure)."""
    H, W = warp.res
    sl = slice_weights(warp.params, warp.params_phi, theta, phi)
    k, t = _cell(pos[..., 1], H)
    j, s = _cell(pos[..., 0], W)
    d0 = _dens(warp, sl, k, k + 1, t, j)
    d1 = _dens(warp, sl, k, k + 1, t, j + 1)
    return (1 - s) * d0 + s * d1
