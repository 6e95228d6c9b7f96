"""Diffuse (Lambertian) BSDF + checkerboard texture + shading frames,
counterpart of the JAX package's `render/lambert.py`.

The two non-neural materials of the matpreview scene: a 0.18-gray diffuse
interior and a checkerboard-textured diffuse ground plane. Cosine-weighted
hemisphere sampling; all functions in the local shading frame (n = +z).
Draws take explicit uniforms.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def make_frame(n: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Orthonormal tangent/bitangent for unit normals (Duff et al. 2017,
    branchless)."""
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b = x * y * a
    t = torch.stack([1.0 + sign * x ** 2 * a, sign * b, -sign * x], dim=-1)
    bt = torch.stack([b, sign + y ** 2 * a, -y], dim=-1)
    return t, bt


def to_local(n, t, bt, w_world):
    return torch.stack([(w_world * t).sum(-1), (w_world * bt).sum(-1), (w_world * n).sum(-1)], dim=-1)


def to_world(n, t, bt, w_local):
    return w_local[..., 0:1] * t + w_local[..., 1:2] * bt + w_local[..., 2:3] * n


def cosine_sample(u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cosine-weighted hemisphere directions + pdf from uniforms u (..., 2)."""
    r = torch.sqrt(u[..., 0])
    phi = 2.0 * math.pi * u[..., 1]
    z = torch.sqrt(torch.clamp(1.0 - u[..., 0], min=1e-9))
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1), z / math.pi


def diffuse_eval(albedo: torch.Tensor, wo_local: torch.Tensor) -> torch.Tensor:
    """f * cos_o (Mitsuba eval convention) for upper-hemisphere wo."""
    cos_o = torch.clamp(wo_local[..., 2], min=0.0)
    return albedo * (cos_o / math.pi)[..., None]


def diffuse_pdf(wo_local: torch.Tensor) -> torch.Tensor:
    return torch.clamp(wo_local[..., 2], min=0.0) / math.pi


def checkerboard(uv: torch.Tensor, color0=0.4, color1=0.2, scale=8.0) -> torch.Tensor:
    """Mitsuba checkerboard: to_uv scale, color0 on even parity."""
    st = torch.floor(uv * scale).to(torch.int32)
    even = (st[..., 0] + st[..., 1]) % 2 == 0
    v = torch.where(even, color0, color1)
    return torch.stack([v, v, v], dim=-1)
