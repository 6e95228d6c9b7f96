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

`eval_principled` returns f * |cos_theta_o| (Mitsuba's eval convention);
`eval_principled_rows` does so for many materials in one batch, each row
under its own material's parameters (`PrincipledRows`), as a scene of
several table matballs evaluates them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from bsdf_diffusion_sampling_tpu_torch.bsdf.microfacet import (
    clearcoat_g,
    fresnel_schlick,
    ggx_d,
    ggx_smith_g1,
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


class PrincipledRows(NamedTuple):
    """Several materials' parameters for one batched evaluation: each field
    a (M,) float32 tensor, material m's value in entry m, every product of
    parameters taken in double first, as `eval_principled` takes it for one
    material. `PrincipledRows.of` builds it; `take` gathers one material a
    row."""

    metallic: torch.Tensor
    roughness: torch.Tensor
    spec_trans: torch.Tensor
    flatness: torch.Tensor
    eta: torch.Tensor
    inv_eta: torch.Tensor
    ax: torch.Tensor
    ay: torch.Tensor
    w_diel: torch.Tensor  # (1 - metallic)(1 - spec_tint): the front Fresnel's dielectric weight
    w_tint: torch.Tensor  # (1 - metallic) spec_tint
    brdf_w: torch.Tensor  # (1 - metallic)(1 - spec_trans)
    bsdf_w: torch.Tensor  # (1 - metallic) spec_trans
    rough2: torch.Tensor  # 2 roughness
    flat_c: torch.Tensor  # 1 - flatness
    sheen_w: torch.Tensor  # (1 - metallic) sheen
    cc_a2m1: torch.Tensor  # alpha^2 - 1 of the clearcoat's GTR1 NDF
    cc_den: torch.Tensor  # pi log(max(alpha^2, 1e-12)), its normaliser
    cc_w: torch.Tensor  # 0.25 clearcoat

    @staticmethod
    def of(params, device) -> "PrincipledRows":
        cols = [_rows_of(p) for p in params]
        t = torch.tensor(cols, dtype=torch.float32, device=device).reshape(len(cols), len(PrincipledRows._fields))
        return PrincipledRows(*t.unbind(1))

    def take(self, index: torch.Tensor) -> "PrincipledRows":
        return PrincipledRows(*(f[index] for f in self))


def _rows_of(p: PrincipledParams):
    """One material's `PrincipledRows` fields as Python floats, each
    product taken in double, so the single-material evaluation multiplies
    by exactly what the batched one gathers."""
    ax, ay = p.alphas
    a_cc = (1.0 - p.clearcoat_gloss) * 0.1 + p.clearcoat_gloss * 0.001
    a2 = a_cc * a_cc
    return PrincipledRows(p.metallic, p.roughness, p.spec_trans, p.flatness, p.eta, 1.0 / p.eta, ax, ay,
                          (1.0 - p.metallic) * (1.0 - p.spec_tint), (1.0 - p.metallic) * p.spec_tint,
                          (1.0 - p.metallic) * (1.0 - p.spec_trans), (1.0 - p.metallic) * p.spec_trans,
                          2.0 * p.roughness, 1.0 - p.flatness, (1.0 - p.metallic) * p.sheen, a2 - 1.0,
                          math.pi * math.log(max(a2, 1e-12)), 0.25 * p.clearcoat)


def _side(front: torch.Tensor, eta, inv_eta) -> torch.Tensor:
    """eta where `front`, else 1/eta: `side_eta` for one material, a select
    of the gathered rows' values for many."""
    if isinstance(eta, torch.Tensor):
        return torch.where(front, eta, inv_eta)
    return side_eta(front, eta)


def _fresnel(cos_theta_i, q: PrincipledRows):
    """`fresnel_dielectric`'s F at the material's eta (per row for many)."""
    eta_it = _side(cos_theta_i >= 0, q.eta, q.inv_eta)
    cti = cos_theta_i.abs()
    sin2_t = (1.0 - cti * cti) / torch.clamp(eta_it * eta_it, min=1e-12)
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    r_s = (cti - eta_it * cos_t) / torch.clamp(cti + eta_it * cos_t, min=1e-12)
    r_p = (eta_it * cti - cos_t) / torch.clamp(eta_it * cti + cos_t, min=1e-12)
    return torch.where(sin2_t >= 1.0, 1.0, 0.5 * (r_s * r_s + r_p * r_p))


def _gtr1(wh, q: PrincipledRows):
    """`gtr1_d` at the clearcoat alpha (per row for many)."""
    z = wh[..., 2]
    d = q.cc_a2m1 / (q.cc_den * (1.0 + q.cc_a2m1 * (z * z)))
    return torch.where(z > 0, d, 0.0)


def eval_principled(p: PrincipledParams, wi: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """f(wi, wo) * |cos_theta_o|, a scalar per direction pair (white base
    colour, so all channels are equal)."""
    return _eval(_rows_of(p), wi, wo, p.spec_trans > 0, p.sheen > 0, p.clearcoat > 0)


def eval_principled_rows(q: PrincipledRows, wi: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """`eval_principled` of many materials in one batch: row r under the
    material whose parameters `q` holds in its entry r (`PrincipledRows.take`
    gathers them). Every lobe is evaluated; a lobe whose weight is 0 on a
    row adds 0 there."""
    return _eval(q, wi, wo, True, True, True)


def _eval(q: PrincipledRows, wi, wo, trans: bool, sheen: bool, clearcoat: bool):
    cos_i, cos_o = wi[..., 2], wo[..., 2]
    front = cos_i > 0
    eta_p = _side(front, q.eta, q.inv_eta)

    reflect = cos_i * cos_o > 0
    refract = cos_i * cos_o < 0

    # generalized half-vector (Walter 2007): wi + eta_p * wo for refraction
    mult = torch.where(reflect, torch.ones_like(eta_p), eta_p)
    wh = wi + mult[..., None] * wo
    wh = wh / torch.clamp(torch.linalg.vector_norm(wh, dim=-1, keepdim=True), min=1e-12)
    wh = wh * torch.sign(wh[..., 2:3])

    d = ggx_d(wh, q.ax, q.ay)
    g = ggx_smith_g1(wi, wh, q.ax, q.ay) * ggx_smith_g1(wo, wh, q.ax, q.ay)
    cos_ih = (wi * wh).sum(-1)
    cos_oh = (wo * wh).sum(-1)
    f_diel = _fresnel(cos_ih, q)

    # ---- main specular reflection: the front-side Fresnel blend (white
    # base colour: metallic Schlick = 1), behind it the transmitted share
    f_tint = fresnel_schlick(schlick_r0_eta(eta_p), cos_ih.abs())
    f_front = q.w_diel * f_diel + q.metallic + q.w_tint * f_tint
    f_pr = torch.where(front, f_front, q.bsdf_w * f_diel)
    spec = f_pr * d * g / (4.0 * torch.clamp(cos_i.abs(), min=1e-8))
    value = torch.where(reflect, spec, 0.0)

    # ---- microfacet transmission (Walter 2007 eq. 21 times |cos_o|; the
    # eta_p^2 half-vector jacobian cancels the 1/eta_p^2 radiance compression)
    if trans:
        denom = torch.clamp((cos_ih + eta_p * cos_oh) ** 2, min=1e-10)
        tr = q.bsdf_w * (1.0 - f_diel) * d * g * (cos_ih * cos_oh / torch.clamp(cos_i.abs(), min=1e-8)
                                                  / denom).abs()
        value = value + torch.where(refract, tr, 0.0)

    # ---- diffuse family (front-side reflection only)
    both_up = front & (cos_o > 0)
    aci, aco = cos_i.abs(), cos_o.abs()
    fo, fi = schlick_weight(aco), schlick_weight(aci)
    f_diff = (1.0 - 0.5 * fo) * (1.0 - 0.5 * fi)
    cos_d = cos_oh  # angle between wo and the half vector
    rr = q.rough2 * cos_d * cos_d
    f_retro = rr * (fo + fi + fo * fi * (rr - 1.0))
    fss90 = 0.5 * rr
    fss = (1.0 + (fss90 - 1.0) * fo) * (1.0 + (fss90 - 1.0) * fi)
    f_ss = 1.25 * (fss * (1.0 / torch.clamp(aci + aco, min=1e-6) - 0.5) + 0.5)
    diffuse = q.brdf_w * aco / math.pi * (q.flat_c * f_diff + q.flatness * f_ss + f_retro)
    value = value + torch.where(both_up, diffuse, 0.0)

    # ---- sheen (white sheen colour for a white base)
    if sheen:
        sheen_v = q.sheen_w * schlick_weight(cos_d.abs()) * aco
        value = value + torch.where(both_up, sheen_v, 0.0)

    # ---- clearcoat
    if clearcoat:
        d_cc = _gtr1(wh, q)
        g_cc = clearcoat_g(wi, wh) * clearcoat_g(wo, wh)
        f_cc = fresnel_schlick(0.04, cos_d.abs())
        value = value + torch.where(both_up, q.cc_w * d_cc * f_cc * g_cc * aco, 0.0)

    return torch.clamp(value, min=0.0)
