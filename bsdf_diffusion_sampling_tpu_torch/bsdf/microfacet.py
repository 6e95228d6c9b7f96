"""Microfacet building blocks: NDFs, Smith shadowing, Fresnel terms
(counterpart of the JAX package's `bsdf/microfacet.py`).

Shared by the principled, roughconductor and roughdielectric evaluators.
Conventions: shading frame with n = +z; directions unit, z-up;
`cos_theta(w) = w[..., 2]`. All functions are batched over leading axes.
"""

from __future__ import annotations

import math

import torch


def cos_theta(w):
    return w[..., 2]


def _sqr(x):
    return x * x


def _dot(a, b):
    return (a * b).sum(-1)


# ------------------------------------------------------------------ NDFs


def ggx_d(wh, alpha_u, alpha_v):
    """Anisotropic GGX (Trowbridge-Reitz) NDF."""
    x, y, z = wh[..., 0], wh[..., 1], wh[..., 2]
    t = _sqr(x / alpha_u) + _sqr(y / alpha_v) + _sqr(z)
    return torch.where(z > 0, 1.0 / (math.pi * alpha_u * alpha_v * _sqr(t)), 0.0)


def beckmann_d(wh, alpha_u, alpha_v):
    x, y, z = wh[..., 0], wh[..., 1], wh[..., 2]
    z2 = torch.clamp(_sqr(z), min=1e-12)
    e = (_sqr(x / alpha_u) + _sqr(y / alpha_v)) / z2
    return torch.where(z > 0, torch.exp(-e) / (math.pi * alpha_u * alpha_v * _sqr(z2)), 0.0)


def ggx_smith_g1(w, wh, alpha_u, alpha_v):
    """Smith masking G1 for GGX, per direction."""
    x, y, z = w[..., 0], w[..., 1], w[..., 2]
    xy_alpha2 = _sqr(alpha_u * x) + _sqr(alpha_v * y)
    tan2 = xy_alpha2 / torch.clamp(_sqr(z), min=1e-12)
    g1 = 2.0 / (1.0 + torch.sqrt(1.0 + tan2))
    side = _dot(w, wh) * z > 0  # wh on the same side as w
    return torch.where(side, g1, 0.0)


def beckmann_smith_g1(w, wh, alpha_u, alpha_v):
    x, y, z = w[..., 0], w[..., 1], w[..., 2]
    alpha = torch.sqrt((_sqr(alpha_u * x) + _sqr(alpha_v * y)) / torch.clamp(x * x + y * y, min=1e-12))
    alpha = torch.where(x * x + y * y < 1e-12, torch.full_like(alpha, alpha_u), alpha)  # isotropic at x=y=0
    cos2 = torch.clamp(_sqr(z), min=1e-12)
    tan_theta = torch.sqrt(torch.clamp(1.0 - cos2, min=0.0) / cos2)
    a = 1.0 / torch.clamp(alpha * tan_theta, min=1e-12)
    # Walter's rational approximation
    g1 = torch.where(a >= 1.6, 1.0, (3.535 * a + 2.181 * a * a) / (1.0 + 2.276 * a + 2.577 * a * a))
    side = _dot(w, wh) * z > 0
    return torch.where(side, g1, 0.0)


def gtr1_d(wh, alpha):
    """GTR1 (Berry) NDF: the Disney clearcoat lobe."""
    z = wh[..., 2]
    a2 = _sqr(alpha)
    t = 1.0 + (a2 - 1.0) * _sqr(z)
    d = (a2 - 1.0) / (math.pi * math.log(max(a2, 1e-12)) * t)
    return torch.where(z > 0, d, 0.0)


def clearcoat_g(w, wh):
    """Separable Smith GGX with fixed alpha 0.25 (Disney clearcoat)."""
    return ggx_smith_g1(w, wh, 0.25, 0.25)


# --------------------------------------------------------------- Fresnel


def schlick_weight(cos_t):
    m = torch.clamp(1.0 - cos_t, 0.0, 1.0)
    return _sqr(_sqr(m)) * m


def fresnel_schlick(f0, cos_t):
    return f0 + (1.0 - f0) * schlick_weight(cos_t)


def schlick_r0_eta(eta):
    return _sqr((eta - 1.0) / (eta + 1.0))


def side_eta(front: torch.Tensor, eta: float) -> torch.Tensor:
    """eta where `front`, else 1/eta (taken in double, then rounded)."""
    return torch.where(front, torch.full(front.shape, eta, device=front.device),
                       torch.full(front.shape, 1.0 / eta, device=front.device))


def fresnel_dielectric(cos_theta_i, eta: float):
    """Exact unpolarized dielectric Fresnel reflectance.

    eta = n_transmitted / n_incident for cos_theta_i > 0; the sign of
    cos_theta_i selects the side (negative = hitting from inside).
    Returns (F, cos_theta_t, eta_it) with cos_theta_t <= 0.
    """
    eta_it = side_eta(cos_theta_i >= 0, eta)
    cti = cos_theta_i.abs()
    sin2_t = (1.0 - _sqr(cti)) / torch.clamp(_sqr(eta_it), min=1e-12)
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    r_s = (cti - eta_it * cos_t) / torch.clamp(cti + eta_it * cos_t, min=1e-12)
    r_p = (eta_it * cti - cos_t) / torch.clamp(eta_it * cti + cos_t, min=1e-12)
    f = 0.5 * (_sqr(r_s) + _sqr(r_p))
    f = torch.where(sin2_t >= 1.0, 1.0, f)  # total internal reflection
    return f, -cos_t, eta_it


def fresnel_conductor(cos_theta_i, eta, k):
    """Unpolarized conductor Fresnel (per channel; eta, k (3,) tensors)."""
    c2 = _sqr(torch.clamp(cos_theta_i, 0.0, 1.0))
    s2 = 1.0 - c2
    e2, k2 = _sqr(eta), _sqr(k)
    t0 = e2 - k2 - s2[..., None]
    a2b2 = torch.sqrt(torch.clamp(_sqr(t0) + 4.0 * e2 * k2, min=0.0))
    t1 = a2b2 + c2[..., None]
    a = torch.sqrt(torch.clamp(0.5 * (a2b2 + t0), min=0.0))
    t2 = 2.0 * a * torch.sqrt(c2)[..., None]
    rs = (t1 - t2) / torch.clamp(t1 + t2, min=1e-12)
    t3 = c2[..., None] * a2b2 + _sqr(s2)[..., None]
    t4 = t2 * s2[..., None]
    rp = rs * (t3 - t4) / torch.clamp(t3 + t4, min=1e-12)
    return 0.5 * (rs + rp)


# conductor eta/k presets (Rec.709-averaged values of the named materials
# Mitsuba's `roughconductor` accepts), as (eta, k) rgb triples
CONDUCTOR_IOR = {
    "Cu": ((0.20, 0.92, 1.10), (3.91, 2.45, 2.14)),
    "Au": ((0.14, 0.37, 1.44), (3.98, 2.39, 1.60)),
    "Al": ((1.35, 0.97, 0.62), (7.47, 6.40, 5.30)),
    "Ag": ((0.16, 0.14, 0.13), (3.93, 3.19, 2.38)),
}

# dielectric ior presets (Mitsuba names)
DIELECTRIC_IOR = {"air": 1.000277, "bk7": 1.5046, "water": 1.3330, "diamond": 2.419}
