"""Rough conductor and rough dielectric microfacet evaluators
(counterpart of the JAX package's `bsdf/rough.py`, after Mitsuba's
`roughconductor` and `roughdielectric` plugins). Both return
f * |cos_theta_o|.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from bsdf_diffusion_sampling_tpu_torch.bsdf.microfacet import (
    CONDUCTOR_IOR,
    DIELECTRIC_IOR,
    beckmann_d,
    beckmann_smith_g1,
    fresnel_conductor,
    fresnel_dielectric,
    ggx_d,
    ggx_smith_g1,
    side_eta,
)

_NDF = {"ggx": (ggx_d, ggx_smith_g1), "beckmann": (beckmann_d, beckmann_smith_g1)}


def _normalize(wh):
    return wh / torch.clamp(torch.linalg.vector_norm(wh, dim=-1, keepdim=True), min=1e-12)


@dataclass(frozen=True)
class RoughConductorParams:
    material: str = "Cu"
    alpha_u: float = 0.1
    alpha_v: float = 0.1
    distribution: str = "ggx"


def eval_roughconductor(p: RoughConductorParams, wi: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """(N, 3) spectral f * cos_theta_o; zero below the surface."""
    d_fn, g1_fn = _NDF[p.distribution]
    eta, k = (torch.tensor(v, dtype=wi.dtype, device=wi.device) for v in CONDUCTOR_IOR[p.material])
    cos_i, cos_o = wi[..., 2], wo[..., 2]
    active = (cos_i > 0) & (cos_o > 0)
    wh = _normalize(wi + wo)
    d = d_fn(wh, p.alpha_u, p.alpha_v)
    g = g1_fn(wi, wh, p.alpha_u, p.alpha_v) * g1_fn(wo, wh, p.alpha_u, p.alpha_v)
    f = fresnel_conductor((wi * wh).sum(-1), eta, k)
    val = f * (d * g / (4.0 * torch.clamp(cos_i.abs(), min=1e-8)))[..., None]
    return torch.where(active[..., None], torch.clamp(val, min=0.0), 0.0)


@dataclass(frozen=True)
class RoughDielectricParams:
    alpha: float = 0.2
    int_ior: float | str = "bk7"
    ext_ior: float | str = "air"
    distribution: str = "beckmann"

    @property
    def eta(self) -> float:
        def _resolve(x):
            return DIELECTRIC_IOR[x] if isinstance(x, str) else float(x)

        return _resolve(self.int_ior) / _resolve(self.ext_ior)


def eval_roughdielectric(p: RoughDielectricParams, wi: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """Scalar f * |cos_theta_o|, reflection and transmission lobes (Walter
    et al. 2007), both hemispheres."""
    d_fn, g1_fn = _NDF[p.distribution]
    eta = p.eta
    cos_i, cos_o = wi[..., 2], wo[..., 2]
    eta_p = side_eta(cos_i > 0, eta)
    reflect = cos_i * cos_o > 0
    refract = cos_i * cos_o < 0

    wh = _normalize(wi + torch.where(reflect, torch.ones_like(eta_p), eta_p)[..., None] * wo)
    wh = wh * torch.sign(wh[..., 2:3])

    d = d_fn(wh, p.alpha, p.alpha)
    g = g1_fn(wi, wh, p.alpha, p.alpha) * g1_fn(wo, wh, p.alpha, p.alpha)
    cos_ih = (wi * wh).sum(-1)
    cos_oh = (wo * wh).sum(-1)
    f, _, _ = fresnel_dielectric(cos_ih, eta)

    refl = f * d * g / (4.0 * torch.clamp(cos_i.abs(), min=1e-8))
    denom = torch.clamp((cos_ih + eta_p * cos_oh) ** 2, min=1e-10)
    # the eta^2 half-vector jacobian cancels the 1/eta^2 radiance compression
    trans = (1.0 - f) * d * g * (cos_ih * cos_oh / torch.clamp(cos_i.abs(), min=1e-8) / denom).abs()
    val = torch.where(reflect, refl, 0.0) + torch.where(refract, trans, 0.0)
    return torch.clamp(val, min=0.0)
