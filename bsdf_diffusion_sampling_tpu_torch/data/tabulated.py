"""Tabulated inverse-CDF sampling of BSDF slices (the reference's
"neusample" data route), counterpart of the JAX package's
`data/tabulated.py`.

For each incoming direction a pdf grid is tabulated from the BRDF oracle on
the (res + 1)^2 vertices of the domain rectangle, averaged over each cell's
4 corners into a pmf, summed into a CDF, and inverse-sampled with in-cell
jitter. Every row of a batch is searched at once (`torch.searchsorted` over
the (B, res^2) CDF rows); nothing loops over rows on the host. The host
twin, in C++, is `native/samplewilib.py`.

Domains: the disk [-1, 1]^2 (cells whose centre has x^2 + y^2 > 0.995 are
masked), the hemisphere theta in [0, pi/2] x phi in [-pi, pi], the full
sphere theta in [0, pi] x phi in [-pi, pi].

Randomness comes from an explicit `torch.Generator`, on its device;
`sample_tabulated_from_uniforms` takes the uniforms themselves, so a test
can hand it what another sampler drew.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Tuple

import torch

from bsdf_diffusion_sampling_tpu_torch.core.device import resolve_device
from bsdf_diffusion_sampling_tpu_torch.geometry.sampling import stratified_sampling_2d

_EXTENTS = {
    "disk": ((-1.0, 1.0), (-1.0, 1.0)),
    "hemisphere": ((0.0, math.pi / 2), (-math.pi, math.pi)),
    "sphere": ((0.0, math.pi), (-math.pi, math.pi)),
}


class Tabulated2D(NamedTuple):
    """A batch of 2-D tabulated distributions over a rectangle."""

    pmf: torch.Tensor  # (B, R, R) cell masses, each row summing to 1
    cdf: torch.Tensor  # (B, R*R) inclusive running sum
    lo: torch.Tensor  # (2,) domain lower corner
    hi: torch.Tensor  # (2,) domain upper corner


def domain_grid(domain: str, res: int, device="cuda") -> torch.Tensor:
    """(res+1)^2 vertex grid over the domain rectangle, (x, y) pairs with x
    the slow axis."""
    device = resolve_device(device)
    (x0, x1), (y0, y1) = _EXTENTS[domain]
    gx, gy = torch.meshgrid(torch.linspace(x0, x1, res + 1, device=device),
                            torch.linspace(y0, y1, res + 1, device=device), indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)


def build_tabulated(pdf_vertices: torch.Tensor, domain: str) -> Tabulated2D:
    """Vertex-value grids (B, R+1, R+1) -> normalized pmf + CDF: each cell
    the mean of its 4 corners."""
    v = torch.clamp(pdf_vertices, min=0.0)
    cell = 0.25 * (v[..., :-1, :-1] + v[..., 1:, :-1] + v[..., :-1, 1:] + v[..., 1:, 1:])
    if domain == "disk":
        r = cell.shape[-1]
        c = (torch.arange(r, dtype=cell.dtype, device=cell.device) + 0.5) / r * 2.0 - 1.0
        gx, gy = torch.meshgrid(c, c, indexing="ij")
        cell = torch.where(gx ** 2 + gy ** 2 > 0.995, 0.0, cell)
    flat = cell.reshape(cell.shape[:-2] + (-1,))
    pmf_flat = flat / torch.clamp(flat.sum(-1, keepdim=True), min=1e-30)
    (x0, x1), (y0, y1) = _EXTENTS[domain]
    return Tabulated2D(pmf=pmf_flat.reshape(cell.shape), cdf=torch.cumsum(pmf_flat, dim=-1),
                       lo=torch.tensor([x0, y0], dtype=cell.dtype, device=cell.device),
                       hi=torch.tensor([x1, y1], dtype=cell.dtype, device=cell.device))


def sample_tabulated_from_uniforms(tab: Tabulated2D, u: torch.Tensor, jitter: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF samples of each of the B rows from uniforms u (B, n) and
    in-cell jitter (B, n, 2) -> (B, n, 2): the first cell whose inclusive
    CDF reaches u (clipped to the last cell: a float32 cumsum need not end
    at 1), then a uniform point in it."""
    res = tab.pmf.shape[-1]
    idx = torch.clamp(torch.searchsorted(tab.cdf.contiguous(), u.contiguous(), right=False), max=res * res - 1)
    cell_xy = torch.stack([torch.div(idx, res, rounding_mode="floor"), idx % res], dim=-1).to(tab.cdf.dtype)
    # lo + (cell + jitter) * ((hi - lo) / res) rounded once, a fused
    # multiply-add as XLA computes the JAX sampler's map: the float32
    # product is exact in float64
    step = (tab.hi - tab.lo) / res
    return (tab.lo.double() + (cell_xy + jitter).double() * step.double()).to(tab.cdf.dtype)


def sample_tabulated(gen: torch.Generator, tab: Tabulated2D, n: int) -> torch.Tensor:
    """n samples from each of the B tabulated rows -> (B, n, 2)."""
    b = tab.cdf.shape[0]
    u = torch.rand((b, n), generator=gen, device=gen.device, dtype=tab.cdf.dtype)
    jitter = torch.rand((b, n, 2), generator=gen, device=gen.device, dtype=tab.cdf.dtype)
    return sample_tabulated_from_uniforms(tab, u, jitter)


def tabulated_pdf(tab: Tabulated2D, x: torch.Tensor) -> torch.Tensor:
    """Density of the samplers above at x (B, n, 2) -> (B, n): the cell's
    pmf over the cell's area."""
    res = tab.pmf.shape[-1]
    ij = torch.clamp(((x - tab.lo) / (tab.hi - tab.lo) * res).to(torch.int64), 0, res - 1)
    b = torch.arange(tab.pmf.shape[0], device=x.device)[:, None]
    return tab.pmf[b, ij[..., 0], ij[..., 1]] / torch.prod((tab.hi - tab.lo) / res)


def online_sampling(pdf_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor], domain: str,
                    gen: torch.Generator, n_wi: int, n_samples_per_wi: int,
                    res: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dataset generation by tabulated inversion: n_wi incoming directions
    stratified over the domain, pdf_fn(wi, wo) tabulated on the (res+1)^2
    wo vertices of each, n_samples_per_wi draws from each table. Returns
    (omega_i, omega_o), each (n_wi * n_samples_per_wi, 2), on the
    generator's device."""
    (x0, x1), (y0, y1) = _EXTENTS[domain]
    u = stratified_sampling_2d(gen, n_wi)
    wi = torch.stack([x0 + u[:, 0] * (x1 - x0), y0 + u[:, 1] * (y1 - y0)], dim=-1)
    grid = domain_grid(domain, res, device=gen.device)
    vals = pdf_fn(wi.repeat_interleave(grid.shape[0], dim=0), grid.repeat(n_wi, 1))
    tab = build_tabulated(vals.reshape(n_wi, res + 1, res + 1), domain)
    wo = sample_tabulated(gen, tab, n_samples_per_wi)
    return wi.repeat_interleave(n_samples_per_wi, dim=0), wo.reshape(-1, 2)
