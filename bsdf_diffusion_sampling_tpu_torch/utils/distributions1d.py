"""Analytic 1-D / 2-D distributions with pdf / icdf / sample, counterpart of
the JAX package's `utils/distributions1d.py` (the reference
implementation's `distribution.py`): the ground truths of the 1-D toy
pipeline and of tests.

Sampling is a stratified inverse-CDF draw: a jittered lattice (i + u_i) / n,
shuffled, mapped through icdf. `sample(gen, n)` draws the lattice from an
explicit `torch.Generator` on its device; `sample_from(u)` maps given
uniforms the same way, so a test can hand it another sampler's lattice.
Beta and CustomDistribution invert tables of `table_size` points.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

_SQRT2 = math.sqrt(2.0)


def stratified_uniform(gen: torch.Generator, n: int, device=None) -> torch.Tensor:
    """Jittered lattice on [0, 1): (i + u_i) / n, shuffled; on `device`
    (the generator's by default)."""
    device = gen.device if device is None else torch.device(device)
    u = (torch.arange(n, dtype=torch.float32, device=device)
         + torch.rand(n, generator=gen, device=device)) / n
    return u[torch.randperm(n, generator=gen, device=device)]


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def _normal_pdf(x, loc: float, scale: float):
    z = (x - loc) / scale
    return torch.exp(-0.5 * z * z) / (scale * math.sqrt(2.0 * math.pi))


def _table_icdf(xs: torch.Tensor, cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of the inverse of a tabulated CDF."""
    idx = torch.clamp(torch.searchsorted(cdf, u.contiguous()), 1, xs.shape[0] - 1)
    c0, c1 = cdf[idx - 1], cdf[idx]
    t = (u - c0) / torch.clamp(c1 - c0, min=1e-12)
    return xs[idx - 1] + t * (xs[idx] - xs[idx - 1])


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """`numpy.interp`: piecewise-linear, held at the end values outside."""
    idx = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1, xp.shape[0] - 1)
    x0, x1 = xp[idx - 1], xp[idx]
    t = torch.clamp((x - x0) / (x1 - x0), 0.0, 1.0)
    return fp[idx - 1] + t * (fp[idx] - fp[idx - 1])


class _Sampled:
    """sample(gen, n) = sample_from(stratified_uniform(gen, n))."""

    def sample_from(self, u):
        return self.icdf(u)

    def sample(self, gen: torch.Generator, n: int):
        return self.sample_from(stratified_uniform(gen, n))


@dataclass(frozen=True)
class Uniform(_Sampled):
    lo: float = 0.0
    hi: float = 1.0

    def pdf(self, x):
        return torch.where((x >= self.lo) & (x <= self.hi), 1.0 / (self.hi - self.lo), 0.0)

    def icdf(self, u):
        return self.lo + u * (self.hi - self.lo)


@dataclass(frozen=True)
class Gaussian(_Sampled):
    loc: float = 0.0
    scale: float = 1.0

    def pdf(self, x):
        return _normal_pdf(x, self.loc, self.scale)

    def icdf(self, u):
        return self.loc + self.scale * _SQRT2 * torch.special.erfinv(2.0 * u - 1.0)

    def sample_from(self, u):
        return self.icdf(torch.clamp(u, 1e-7, 1 - 1e-7))


@dataclass(frozen=True)
class TruncatedGaussian(_Sampled):
    loc: float = 0.0
    scale: float = 1.0
    lo: float = -1.0
    hi: float = 1.0

    def _cdf(self, x):
        return 0.5 * (1.0 + torch.special.erf((x - self.loc) / (self.scale * _SQRT2)))

    def pdf(self, x):
        z = self._cdf(_f32(self.hi, x)) - self._cdf(_f32(self.lo, x))
        return torch.where((x >= self.lo) & (x <= self.hi), _normal_pdf(x, self.loc, self.scale) / z, 0.0)

    def icdf(self, u):
        c_lo, c_hi = self._cdf(_f32(self.lo, u)), self._cdf(_f32(self.hi, u))
        uu = c_lo + u * (c_hi - c_lo)
        return self.loc + self.scale * _SQRT2 * torch.special.erfinv(2.0 * uu - 1.0)

    def sample_from(self, u):
        return self.icdf(torch.clamp(u, 1e-7, 1 - 1e-7))


@dataclass(frozen=True)
class Beta(_Sampled):
    """Beta(a, b) with an icdf by a tabulated inverse on [0, 1]."""

    a: float = 2.0
    b: float = 2.0
    table_size: int = 4096

    def pdf(self, x):
        log_b = math.lgamma(self.a) + math.lgamma(self.b) - math.lgamma(self.a + self.b)
        inside = (x >= 0.0) & (x <= 1.0)
        xc = torch.where(inside, x, 0.5)
        v = torch.exp((self.a - 1.0) * torch.log(xc) + (self.b - 1.0) * torch.log1p(-xc) - log_b)
        return torch.where(inside, v, 0.0)

    def _tables(self, device):
        xs = torch.linspace(1e-6, 1.0 - 1e-6, self.table_size, device=device)
        cdf = torch.cumsum(self.pdf(xs), 0)
        return xs, cdf / cdf[-1]

    def icdf(self, u):
        return _table_icdf(*self._tables(u.device), u)


@dataclass(frozen=True)
class StraightLine(_Sampled):
    """Linear density p(x) = 2x on [0, 1]."""

    def pdf(self, x):
        return torch.where((x >= 0) & (x <= 1), 2.0 * x, 0.0)

    def icdf(self, u):
        return torch.sqrt(u)


@dataclass(frozen=True)
class TwoDCombination:
    """Independent product of two 1-D distributions."""

    dist_x: object
    dist_y: object

    def pdf(self, xy):
        return self.dist_x.pdf(xy[..., 0]) * self.dist_y.pdf(xy[..., 1])

    def sample_from(self, ux, uy):
        return torch.stack([self.dist_x.sample_from(ux), self.dist_y.sample_from(uy)], dim=-1)

    def sample(self, gen: torch.Generator, n: int):
        return torch.stack([self.dist_x.sample(gen, n), self.dist_y.sample(gen, n)], dim=-1)


@dataclass(frozen=True)
class CustomDistribution(_Sampled):
    """An arbitrary 1-D density on [lo, hi] (a batched torch function) with
    a trapezoid CDF table and its linear inverse."""

    pdf_fn: Callable
    lo: float
    hi: float
    table_size: int = 4096

    def _tables(self, device):
        xs = torch.linspace(self.lo, self.hi, self.table_size, device=device)
        p = torch.clamp(self.pdf_fn(xs), min=0.0)
        seg = 0.5 * (p[:-1] + p[1:])
        cdf = torch.cat([torch.zeros(1, device=device), torch.cumsum(seg, 0)])
        return xs, p, cdf / cdf[-1]

    def pdf(self, x):
        xs, p, _ = self._tables(x.device)
        return _interp(x, xs, p) / torch.trapezoid(p, xs)

    def icdf(self, u):
        xs, _, cdf = self._tables(u.device)
        return _table_icdf(xs, cdf, u)
