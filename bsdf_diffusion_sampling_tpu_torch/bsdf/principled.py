"""Disney principled BSDF evaluator, reflection and rough transmission
(counterpart of the JAX package's `bsdf/principled.py`, which follows
Mitsuba's `principled` plugin with a white base colour).

Lobes (Burley 2012/2015 as Mitsuba implements them):
- main specular: anisotropic GGX x Smith G x the principled Fresnel blend;
- microfacet transmission: weight (1 - metallic) * spec_trans, the
  dielectric Fresnel complement, generalized half-vector wi + eta * wo;
- diffuse + retro-reflection + flatness, weight (1 - metallic) *
  (1 - spec_trans);
- sheen: (1 - metallic) * sheen, Schlick grazing weight;
- clearcoat: GTR1 NDF, fixed 0.04 Fresnel, Smith G at alpha 0.25.

`eval_principled` returns f * |cos_theta_o| (Mitsuba's eval convention).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from bsdf_diffusion_sampling_tpu_torch.bsdf.microfacet import (
    clearcoat_g,
    fresnel_dielectric,
    fresnel_schlick,
    ggx_d,
    ggx_smith_g1,
    gtr1_d,
    schlick_r0_eta,
    schlick_weight,
    side_eta,
)


@dataclass(frozen=True)
class PrincipledParams:
    metallic: float = 0.0
    specular: float = 0.5
    roughness: float = 0.5
    spec_tint: float = 0.0
    anisotropic: float = 0.0
    sheen: float = 0.0
    sheen_tint: float = 0.0
    clearcoat: float = 0.0
    clearcoat_gloss: float = 0.0
    spec_trans: float = 0.0
    flatness: float = 0.0
    # base_color is fixed at white, as in the reference material tables

    @property
    def eta(self) -> float:
        # specular -> relative IOR (Mitsuba's principled mapping)
        return 2.0 / (1.0 - (0.08 * self.specular) ** 0.5) - 1.0

    @property
    def alphas(self):
        r2 = max(self.roughness**2, 1e-4)
        if self.anisotropic <= 0.0:
            return r2, r2
        aspect = (1.0 - 0.9 * self.anisotropic) ** 0.5
        return max(r2 / aspect, 1e-4), max(r2 * aspect, 1e-4)


def _principled_fresnel(p: PrincipledParams, f_dielectric, cos_d, front, eta_p):
    """Front-side Fresnel blend (white base colour: metallic Schlick = 1)."""
    f_tint = fresnel_schlick(schlick_r0_eta(eta_p), cos_d.abs())
    f_front = ((1.0 - p.metallic) * (1.0 - p.spec_tint) * f_dielectric + p.metallic
               + (1.0 - p.metallic) * p.spec_tint * f_tint)
    bsdf_w = (1.0 - p.metallic) * p.spec_trans
    return torch.where(front, f_front, bsdf_w * f_dielectric)


def eval_principled(p: PrincipledParams, wi: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """f(wi, wo) * |cos_theta_o|, a scalar per direction pair (white base
    colour, so all channels are equal)."""
    cos_i, cos_o = wi[..., 2], wo[..., 2]
    front = cos_i > 0
    eta = p.eta
    eta_p = side_eta(front, eta)
    brdf_w = (1.0 - p.metallic) * (1.0 - p.spec_trans)
    bsdf_w = (1.0 - p.metallic) * p.spec_trans

    reflect = cos_i * cos_o > 0
    refract = cos_i * cos_o < 0

    # generalized half-vector (Walter 2007): wi + eta_p * wo for refraction
    mult = torch.where(reflect, torch.ones_like(eta_p), eta_p)
    wh = wi + mult[..., None] * wo
    wh = wh / torch.clamp(torch.linalg.vector_norm(wh, dim=-1, keepdim=True), min=1e-12)
    wh = wh * torch.sign(wh[..., 2:3])

    ax, ay = p.alphas
    d = ggx_d(wh, ax, ay)
    g = ggx_smith_g1(wi, wh, ax, ay) * ggx_smith_g1(wo, wh, ax, ay)
    cos_ih = (wi * wh).sum(-1)
    cos_oh = (wo * wh).sum(-1)
    f_diel, _, _ = fresnel_dielectric(cos_ih, eta)

    # ---- main specular reflection
    f_pr = _principled_fresnel(p, f_diel, cos_ih, front, eta_p)
    spec = f_pr * d * g / (4.0 * torch.clamp(cos_i.abs(), min=1e-8))
    value = torch.where(reflect, spec, 0.0)

    # ---- microfacet transmission (Walter 2007 eq. 21 times |cos_o|; the
    # eta_p^2 half-vector jacobian cancels the 1/eta_p^2 radiance compression)
    if p.spec_trans > 0:
        denom = torch.clamp((cos_ih + eta_p * cos_oh) ** 2, min=1e-10)
        trans = bsdf_w * (1.0 - f_diel) * d * g * (cos_ih * cos_oh / torch.clamp(cos_i.abs(), min=1e-8)
                                                   / denom).abs()
        value = value + torch.where(refract, trans, 0.0)

    # ---- diffuse family (front-side reflection only)
    both_up = front & (cos_o > 0)
    aci, aco = cos_i.abs(), cos_o.abs()
    fo, fi = schlick_weight(aco), schlick_weight(aci)
    f_diff = (1.0 - 0.5 * fo) * (1.0 - 0.5 * fi)
    cos_d = cos_oh  # angle between wo and the half vector
    rr = 2.0 * p.roughness * cos_d * cos_d
    f_retro = rr * (fo + fi + fo * fi * (rr - 1.0))
    fss90 = 0.5 * rr
    fss = (1.0 + (fss90 - 1.0) * fo) * (1.0 + (fss90 - 1.0) * fi)
    f_ss = 1.25 * (fss * (1.0 / torch.clamp(aci + aco, min=1e-6) - 0.5) + 0.5)
    diffuse = brdf_w * aco / math.pi * ((1.0 - p.flatness) * f_diff + p.flatness * f_ss + f_retro)
    value = value + torch.where(both_up, diffuse, 0.0)

    # ---- sheen (white sheen colour for a white base)
    if p.sheen > 0:
        sheen_v = (1.0 - p.metallic) * p.sheen * schlick_weight(cos_d.abs()) * aco
        value = value + torch.where(both_up, sheen_v, 0.0)

    # ---- clearcoat
    if p.clearcoat > 0:
        alpha_cc = (1.0 - p.clearcoat_gloss) * 0.1 + p.clearcoat_gloss * 0.001
        d_cc = gtr1_d(wh, alpha_cc)
        g_cc = clearcoat_g(wi, wh) * clearcoat_g(wo, wh)
        f_cc = fresnel_schlick(0.04, cos_d.abs())
        value = value + torch.where(both_up, 0.25 * p.clearcoat * d_cc * f_cc * g_cc * aco, 0.0)

    return torch.clamp(value, min=0.0)
