"""The Disney principled BSDF's value times |cos theta_o| (white base
colour), written from Burley 2012/2015 as Mitsuba's `principled` plugin
implements it: anisotropic GGX specular with Smith masking and the
principled Fresnel blend, rough microfacet transmission through the
generalized half vector (Walter et al. 2007), the diffuse, retro-reflection
and flatness terms, sheen and the GTR1 clearcoat. The parameters come from
the configuration's file."""

from __future__ import annotations

import math

import torch

from .flow import FP32, Prec


def _schlick_w(c):
    m = torch.clamp(1.0 - c, 0.0, 1.0)
    return m ** 5


def _ggx(wh, ax, ay):
    t = (wh[:, 0] / ax) ** 2 + (wh[:, 1] / ay) ** 2 + wh[:, 2] ** 2
    return torch.where(wh[:, 2] > 0, 1.0 / (math.pi * ax * ay * t * t), 0.0)


def _g1(w, wh, ax, ay):
    tan2 = ((ax * w[:, 0]) ** 2 + (ay * w[:, 1]) ** 2) / torch.clamp(w[:, 2] ** 2, min=1e-12)
    return torch.where((w * wh).sum(-1) * w[:, 2] > 0, 2.0 / (1.0 + torch.sqrt(1.0 + tan2)), 0.0)


def _fresnel(cos_i, eta: float):
    """Unpolarised dielectric reflectance; eta = n_t / n_i on the front."""
    e = torch.where(cos_i >= 0, eta, 1.0 / eta)
    c = cos_i.abs()
    s2 = (1.0 - c * c) / torch.clamp(e * e, min=1e-12)
    ct = torch.sqrt(torch.clamp(1.0 - s2, min=0.0))
    rs = (c - e * ct) / torch.clamp(c + e * ct, min=1e-12)
    rp = (e * c - ct) / torch.clamp(e * c + ct, min=1e-12)
    return torch.where(s2 >= 1.0, 1.0, 0.5 * (rs * rs + rp * rp))


def eval_principled(p: dict, wi, wo, prec: Prec = FP32):
    """(N,) f(wi, wo) |cos theta_o|."""
    ci, co = wi[:, 2], wo[:, 2]
    front = ci > 0
    eta = 2.0 / (1.0 - math.sqrt(0.08 * p["specular"])) - 1.0
    eta_p = torch.where(front, eta, 1.0 / eta)
    met, st = p["metallic"], p["spec_trans"]
    brdf_w, bsdf_w = (1 - met) * (1 - st), (1 - met) * st
    refl, refr = ci * co > 0, ci * co < 0
    wh = wi + torch.where(refl, 1.0, eta_p)[:, None] * wo
    wh = wh / torch.clamp(torch.linalg.vector_norm(wh, dim=-1, keepdim=True), min=1e-12)
    wh = wh * torch.sign(wh[:, 2:3])
    r2 = max(p["roughness"] ** 2, 1e-4)
    asp = math.sqrt(1.0 - 0.9 * p["anisotropic"]) if p["anisotropic"] > 0 else 1.0
    ax, ay = max(r2 / asp, 1e-4), max(r2 * asp, 1e-4)
    d = _ggx(wh, ax, ay)
    g = _g1(wi, wh, ax, ay) * _g1(wo, wh, ax, ay)
    cih, coh = (wi * wh).sum(-1), (wo * wh).sum(-1)
    fd = _fresnel(cih, eta)
    r0 = ((eta_p - 1) / (eta_p + 1)) ** 2
    f_tint = r0 + (1 - r0) * _schlick_w(cih.abs())
    f_front = (1 - met) * (1 - p["spec_tint"]) * fd + met + (1 - met) * p["spec_tint"] * f_tint
    f_pr = torch.where(front, f_front, bsdf_w * fd)
    value = torch.where(refl, f_pr * d * g / (4.0 * torch.clamp(ci.abs(), min=1e-8)), 0.0)
    if st > 0:
        den = torch.clamp((cih + eta_p * coh) ** 2, min=1e-10)
        tr = bsdf_w * (1 - fd) * d * g * (cih * coh / torch.clamp(ci.abs(), min=1e-8) / den).abs()
        value = value + torch.where(refr, tr, 0.0)
    up = front & (co > 0)
    aci, aco = ci.abs(), co.abs()
    fo, fi = _schlick_w(aco), _schlick_w(aci)
    rr = 2.0 * p["roughness"] * coh * coh
    retro = rr * (fo + fi + fo * fi * (rr - 1.0))
    fss = (1.0 + (0.5 * rr - 1.0) * fo) * (1.0 + (0.5 * rr - 1.0) * fi)
    ss = 1.25 * (fss * (1.0 / torch.clamp(aci + aco, min=1e-6) - 0.5) + 0.5)
    fl = p["flatness"]
    diffuse = brdf_w * aco / math.pi * ((1 - fl) * (1 - 0.5 * fo) * (1 - 0.5 * fi) + fl * ss + retro)
    value = value + torch.where(up, diffuse, 0.0)
    if p["sheen"] > 0:
        value = value + torch.where(up, (1 - met) * p["sheen"] * _schlick_w(coh.abs()) * aco, 0.0)
    if p["clearcoat"] > 0:
        a = (1 - p["clearcoat_gloss"]) * 0.1 + p["clearcoat_gloss"] * 0.001
        a2 = a * a
        dcc = torch.where(wh[:, 2] > 0, (a2 - 1) / (math.pi * math.log(max(a2, 1e-12)) * (1 + (a2 - 1) * wh[:, 2] ** 2)),
                          0.0)
        gcc = _g1(wi, wh, 0.25, 0.25) * _g1(wo, wh, 0.25, 0.25)
        fcc = 0.04 + 0.96 * _schlick_w(coh.abs())
        value = value + torch.where(up, 0.25 * p["clearcoat"] * dcc * fcc * gcc * aco, 0.0)
    return prec.q(torch.clamp(value, min=0.0))
