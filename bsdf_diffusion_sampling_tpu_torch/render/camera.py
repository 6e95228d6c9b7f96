"""Perspective camera + film sampling, counterpart of the JAX package's
`render/camera.py`.

Perspective lookat camera with fov on the smaller axis, and a gaussian
reconstruction filter applied by filter importance sampling: pixel offsets
are drawn from a truncated gaussian (stddev 0.5, radius 2), so every
sample splats with weight 1 and the film is a plain average
(`accumulate_film`). Draws take explicit uniforms.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch


class Camera(NamedTuple):
    origin: torch.Tensor  # (3,)
    right: torch.Tensor  # (3,) scaled by tan(fov/2) * aspect
    up: torch.Tensor  # (3,) scaled by tan(fov/2)
    forward: torch.Tensor  # (3,) unit
    width: int
    height: int

    @property
    def vectors(self) -> torch.Tensor:
        """(4, 3) [origin, right, up, forward]."""
        return torch.stack([self.origin, self.right, self.up, self.forward])


def make_camera(origin, target, up, fov_deg: float, width: int, height: int) -> Camera:
    o = np.asarray(origin, np.float64)
    fwd = np.asarray(target, np.float64) - o
    fwd /= np.linalg.norm(fwd)
    r = np.cross(fwd, np.asarray(up, np.float64))
    r /= np.linalg.norm(r)
    u = np.cross(r, fwd)
    tan_half = np.tan(np.deg2rad(fov_deg) / 2.0)
    # fov applies to the smaller axis (fov_axis="smaller")
    if width <= height:
        r_scale, u_scale = tan_half, tan_half * height / width
    else:
        r_scale, u_scale = tan_half * width / height, tan_half

    def f32(x):
        return torch.from_numpy(np.asarray(x, np.float32))

    return Camera(origin=f32(o), right=f32(r * r_scale), up=f32(u * u_scale), forward=f32(fwd),
                  width=width, height=height)


def _truncated_gaussian(u: torch.Tensor, stddev=0.5, radius=2.0) -> torch.Tensor:
    """Box-Muller gaussian from uniforms u (..., 2) in [1e-7, 1), folded
    into [-radius, radius]."""
    r = stddev * torch.sqrt(-2.0 * torch.log(u[..., 0]))
    phi = 2.0 * math.pi * u[..., 1]
    g = torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)
    return torch.clamp(g, -radius, radius)


def generate_rays(cam_vectors: torch.Tensor, width: int, height: int, u: torch.Tensor, spp_chunk: int,
                  row0: int = 0, rows: int | None = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`spp_chunk` samples per pixel of the film rows [row0, row0 + rows),
    laid out sample-major: px = tile(arange(rows * w), spp_chunk) + row0 * w.
    `u` (W*rows*spp_chunk, 2) are the filter's uniforms in [1e-7, 1).
    Returns (ro, rd, pixel_index)."""
    origin, right, up, forward = cam_vectors
    w, h = width, height
    rows = h if rows is None else rows
    px = torch.arange(rows * w, dtype=torch.int32, device=cam_vectors.device).repeat(spp_chunk) + row0 * w
    x = (px % w).to(torch.float32)
    y = torch.div(px, w, rounding_mode="floor").to(torch.float32)
    jit = _truncated_gaussian(u)
    sx = (x + 0.5 + jit[:, 0]) / w * 2.0 - 1.0
    sy = (y + 0.5 + jit[:, 1]) / h * 2.0 - 1.0
    d = forward[None, :] + sx[:, None] * right[None, :] - sy[:, None] * up[None, :]
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return origin.expand_as(d), d, px


def accumulate_film(pixel_index: torch.Tensor, radiance: torch.Tensor, width: int,
                    height: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segment-sum samples into an (H, W, 3) film and (H, W) per-pixel
    counts, on the samples' device. The integrator sums its film without
    a scatter; this is the general form, for samples in any pixel order."""
    idx = pixel_index.long()
    img = torch.zeros(width * height, 3, dtype=radiance.dtype, device=radiance.device).index_add_(0, idx, radiance)
    cnt = torch.zeros(width * height, dtype=torch.float32, device=radiance.device).index_add_(
        0, idx, torch.ones(idx.shape[0], dtype=torch.float32, device=radiance.device))
    return img.reshape(height, width, 3), cnt.reshape(height, width)
