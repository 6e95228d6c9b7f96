"""Analytic GGX shading densities, the training targets and test oracles
(counterpart of the JAX package's `bsdf/analytic.py`).

GGX NDF x Smith-Schlick G x Schlick Fresnel, times cos(theta_o), plus an
optional diffuse share: an *unnormalized* density over the projected disk
or over (theta, phi). The NDF keeps the reference's form, which does not
square n.h: D = a^2 / (pi (n.h (a^2 - 1) + 1)^2), a = roughness^2, so the
two packages' targets are the same function.
"""

from __future__ import annotations

import math

import torch

from bsdf_diffusion_sampling_tpu_torch.geometry.coords import disk_to_cart, spher_to_cart


def _ndf_ggx(n_dot_h: torch.Tensor, roughness: float) -> torch.Tensor:
    alpha = roughness**2
    return alpha**2 / (math.pi * (n_dot_h * (alpha**2 - 1.0) + 1.0) ** 2)


def _g_smith_schlick(n_dot_l, n_dot_v, roughness: float):
    k = (roughness + 1.0) ** 2 / 8.0
    return n_dot_l / (n_dot_l * (1.0 - k) + k) * (n_dot_v / (n_dot_v * (1.0 - k) + k))


def _fresnel_schlick(cos_theta, f0: float):
    return f0 + (1.0 - f0) * (1.0 - cos_theta) ** 5


def _shading(light_dir, view_dir, roughness: float, f0: float, diffuse_prob: float) -> torch.Tensor:
    half = light_dir + view_dir
    half = half / torch.linalg.vector_norm(half, dim=-1, keepdim=True)
    n_dot_l, n_dot_v = light_dir[..., 2], view_dir[..., 2]
    d = _ndf_ggx(half[..., 2], roughness)
    g = _g_smith_schlick(n_dot_l, n_dot_v, roughness)
    f = _fresnel_schlick((view_dir * half).sum(-1), f0)
    f_spec = (d * g * f) / (4.0 * n_dot_l * n_dot_v + 1e-10)
    cos_term = torch.clamp(n_dot_v, min=0.0)
    return (1.0 - diffuse_prob) * f_spec * cos_term + diffuse_prob * cos_term / math.pi


def ggx_shading_disk(omega_i: torch.Tensor, omega_o: torch.Tensor, roughness: float, f0: float = 0.04,
                     diffuse_prob: float = 0.0) -> torch.Tensor:
    """Unnormalized target density over disk coordinates (N, 2) -> (N,)."""
    return _shading(disk_to_cart(omega_i), disk_to_cart(omega_o), roughness, f0, diffuse_prob)


def ggx_shading_spherical(omega_i: torch.Tensor, omega_o: torch.Tensor, roughness: float, f0: float = 0.04,
                          diffuse_prob: float = 0.0) -> torch.Tensor:
    """Unnormalized target density over (theta, phi) (N, 2) -> (N,)."""
    li = spher_to_cart(omega_i[..., 0], omega_i[..., 1])
    vo = spher_to_cart(omega_o[..., 0], omega_o[..., 1])
    return _shading(li, vo, roughness, f0, diffuse_prob)
