"""Validation metrics: KL between a sample histogram and a pdf grid
and image errors (counterpart of the JAX package's `utils/validation.py`,
the port's own numpy copy).

- `kl_divergence_grid`: KL(p || q) of two nonnegative grids, each
  normalised to sum 1;
- `pdf_grid_2d`: a batched 2-D density on a bins x bins cell-centre grid,
  or averaged over sub x sub points of each cell;
- `histogram_grid_2d`: the density-normalised 2-D histogram on that grid;
- `sampler_vs_pdf_kl`: KL of a sample histogram against a pdf grid;
- `image_mse`, `relative_mse`: image errors of a render against a reference.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from bsdf_diffusion_sampling_tpu_torch.core.device import resolve_device


def kl_divergence_grid(p: np.ndarray, q: np.ndarray, eps: float = 1e-12) -> float:
    """KL(p || q) for two nonnegative grids, each normalised to sum 1."""
    p = np.maximum(np.asarray(p, np.float64), 0)
    q = np.maximum(np.asarray(q, np.float64), 0)
    p = p / max(p.sum(), eps)
    q = q / max(q.sum(), eps)
    mask = p > eps
    return float(np.sum(p[mask] * np.log(p[mask] / np.maximum(q[mask], eps))))


def pdf_grid_2d(
    pdf_fn: Callable[[torch.Tensor], torch.Tensor],
    lo: Tuple[float, float],
    hi: Tuple[float, float],
    bins: int = 64,
    device="cuda",
    sub: int = 1,
) -> np.ndarray:
    """Evaluate a batched 2-D density at the bins x bins cell centres, given
    to `pdf_fn` as one float32 tensor of points (n, 2) on `device` (the card
    by default; pass device="cpu" for the CPU). With
    `sub` > 1 each cell holds the mean over the centres of its sub x sub
    sub-cells: the cell's integral, which a histogram estimates, where the
    centre's value is off by the density's curvature."""
    device = resolve_device(device)
    n = bins * sub
    cx = np.linspace(lo[0], hi[0], n + 1)
    cy = np.linspace(lo[1], hi[1], n + 1)
    cx = 0.5 * (cx[1:] + cx[:-1])
    cy = 0.5 * (cy[1:] + cy[:-1])
    gx, gy = np.meshgrid(cx, cy, indexing="ij")
    pts = torch.as_tensor(np.stack([gx.ravel(), gy.ravel()], -1), dtype=torch.float32, device=device)
    return pdf_fn(pts).detach().cpu().numpy().reshape(bins, sub, bins, sub).mean(axis=(1, 3))


def histogram_grid_2d(
    samples: np.ndarray,
    lo: Tuple[float, float],
    hi: Tuple[float, float],
    bins: int = 64,
) -> np.ndarray:
    """Density-normalised 2-D histogram on the grid of pdf_grid_2d."""
    h, _, _ = np.histogram2d(samples[:, 0], samples[:, 1], bins=bins, range=[[lo[0], hi[0]], [lo[1], hi[1]]],
                             density=True)
    return h


def sampler_vs_pdf_kl(
    samples: np.ndarray,
    pdf_fn: Callable[[torch.Tensor], torch.Tensor],
    lo: Tuple[float, float],
    hi: Tuple[float, float],
    bins: int = 64,
    device="cuda",
    sub: int = 1,
) -> float:
    """KL(sample histogram || pdf grid): draws from a learned sampler against
    an analytic pdf, or analytic draws against a learned pdf. `device` and
    `sub` go to `pdf_grid_2d`."""
    return kl_divergence_grid(histogram_grid_2d(samples, lo, hi, bins),
                              pdf_grid_2d(pdf_fn, lo, hi, bins, device=device, sub=sub))


def image_mse(a: np.ndarray, b: np.ndarray) -> float:
    """MSE between two HDR images, in float64."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    return float(np.mean((a - b) ** 2))


def relative_mse(a: np.ndarray, b: np.ndarray, eps: float = 1e-2) -> float:
    """Relative MSE of `a` against the reference `b`: (a - b)^2 / (b^2 + eps),
    averaged, in float64."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.mean((a - b) ** 2 / (b * b + eps)))
