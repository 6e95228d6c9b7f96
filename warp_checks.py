"""The cases that hold the envmap's and the measured BRDF's kernels
(`csrc/warp2d.cu`) against their plain versions, shared by `chip_smoke.py`
(phase 6b) and `tests/test_torch_warp_kernel.py`.

- `warp_inputs`: rows with their edge rows first;
- `warp_calls`: every entry point's outputs, kernel or plain;
- `warp_gaps`: kernel against plain, a row's gap held to WARP_TOL unless
  the row is a binary-search tie (`warp_ties`) or ill-conditioned
  (`warp_ill_conditioned`); the share of rows bit-equal is reported, not
  held.

It imports neither jax nor the JAX package.
"""

from __future__ import annotations

import math

import torch

from bsdf_diffusion_sampling_tpu_torch.bsdf import measured as me
from bsdf_diffusion_sampling_tpu_torch.bsdf.marginal2d import warp_sample
from bsdf_diffusion_sampling_tpu_torch.core.prng import root_generator
from bsdf_diffusion_sampling_tpu_torch.render import envmap as em

# A row gaps by the widest relative gap of its values and pdfs (absolute
# below 1e-6) or the widest component gap of its direction; every row that
# is neither a tie nor ill-conditioned must hold WARP_TOL.
WARP_TOL = 1e-5
# A tie: a row whose plain warp position lies within WARP_TIE_BAND cells of a
# cell edge, where a one-ulp difference can move a binary search or a lookup
# to the neighbouring cell.
WARP_TIE_BAND = 1e-4
# Ill-conditioned: a row with a direction whose sin(theta) from its pole is
# below WARP_POLE. There acos, atan2 and the 1 / sin(theta) of the solid-angle
# pdfs amplify one ulp (2^-24) of a product or sum rounded in another order
# by ~1 / sin^2(theta), past WARP_TOL.
WARP_POLE = math.sqrt(2.0 ** -24 / WARP_TOL)
BRDF_QUERIES = ("eval_brdf", "pdf_brdf", "eval_pdf_brdf", "eval_lum")


def _unit_dirs(gen, n: int, lower: float, device) -> torch.Tensor:
    """Unit directions with cos(theta) uniform in [lower, 1]."""
    ct = lower + (1.0 - lower) * torch.rand(n, generator=gen, device=device)
    phi = (torch.rand(n, generator=gen, device=device) * 2 - 1) * math.pi
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], -1)


def warp_inputs(n: int, seed: int, device):
    """(u (n, 2), wi (n, 3), wo (n, 3), d (n, 3)), edge rows first: u at 0
    and 1 - 2^-24, grazing wi (cos 1e-4, 1e-6, 0, -1e-4), wo below the
    surface, d at the envmap's poles."""
    gen = root_generator(seed, device)
    u = torch.rand((n, 2), generator=gen, device=device)
    edge = 1.0 - 2.0 ** -24
    u[:4] = torch.tensor([[0.0, 0.0], [edge, edge], [0.0, edge], [edge, 0.0]], device=device)
    wi = _unit_dirs(gen, n, 0.0, device)
    cz = torch.tensor([1e-4, 1e-6, 0.0, -1e-4], device=device)
    wi[4:8] = torch.stack([torch.sqrt(1.0 - cz * cz), torch.zeros_like(cz), cz], -1)
    wo = _unit_dirs(gen, n, -0.3, device)
    wo[8:12, 2] = -wo[8:12, 2].abs()
    d = _unit_dirs(gen, n, -1.0, device)
    d[12:14] = torch.tensor([[0.0, 1.0, 0.0], [0.0, -1.0, 0.0]], device=device)
    return u, wi, wo, d


def warp_calls(env, brdf, u, wi, wo, d, plain: bool) -> dict:
    """Every entry point's outputs, through the public entry point (the
    kernel, for CUDA tensors) or its plain version."""
    sfx = "_plain" if plain else ""
    out = {}
    if env is not None:
        for entry, args in (("sample_env", (u,)), ("eval_env", (d,)), ("pdf_env", (d,))):
            out[entry] = getattr(em, entry + sfx)(env, *args)
    if brdf is not None:
        for entry in BRDF_QUERIES:
            out[entry] = getattr(me, entry + sfx)(brdf, wi, wo)
        out["sample_brdf"] = getattr(me, "sample_brdf" + sfx)(brdf, u, wi)
    return out


def _warp_edges(warp, pos: torch.Tensor) -> torch.Tensor:
    """Rows whose position lies within WARP_TIE_BAND cells of an inner cell
    edge (the outer ones have no neighbouring cell)."""
    H, W = warp.res
    out = torch.zeros(pos.shape[:-1], dtype=torch.bool, device=pos.device)
    for i, n in ((0, W), (1, H)):
        c = pos[..., i] * (n - 1)
        k = torch.round(c)
        out |= ((c - k).abs() < WARP_TIE_BAND) & (k >= 1) & (k <= n - 2)
    return out


def warp_ties(env, brdf, u, wi, wo, d) -> dict:
    """{entry: rows that are ties}, from the plain versions' warp positions."""
    out = {}
    if env is not None:
        pos, _ = warp_sample(env.warp, u, torch.zeros_like(u[:, 0]))
        uv = torch.stack(em._dir_to_uv(d @ env.to_local.T), -1)
        out["sample_env"] = _warp_edges(env.warp, pos)
        out["eval_env"] = out["pdf_env"] = _warp_edges(env.warp, uv)
    if brdf is not None:
        theta_i, phi_i = me._spherical(wi)
        s, _ = warp_sample(brdf.luminance, u, theta_i, phi_i)
        u_wm, _ = warp_sample(brdf.vndf, s, theta_i, phi_i)
        out["sample_brdf"] = _warp_edges(brdf.luminance, s) | _warp_edges(brdf.vndf, u_wm)
        _, _, _, _, _, u_x, u_y, s_q, _ = me._query(brdf, wi, wo)
        q = _warp_edges(brdf.vndf, torch.stack([u_x, u_y], -1)) | _warp_edges(brdf.luminance, s_q)
        for entry in BRDF_QUERIES:
            out[entry] = q
    return out


def _near_pole(w: torch.Tensor, axis: int) -> torch.Tensor:
    """Rows of `w` whose sin(theta) from the `axis` pole is below WARP_POLE."""
    w = w.double()
    norm = torch.linalg.vector_norm(w, dim=-1)
    side = torch.sqrt(torch.clamp(norm * norm - w[..., axis] ** 2, min=0.0))
    return side < WARP_POLE * norm


def warp_ill_conditioned(env, brdf, wi, wo, d, want: dict) -> dict:
    """{entry: rows that are ill-conditioned}: for the envmap, the plain
    direction (drawn or given) near the lat-long map's poles (local y); for
    the BRDF's queries, wi or the half vector of (wi, wo) near the normal
    (z), whose atan2 and acos give phi_i, phi_m and theta_m; for its draw, wi
    alone (the draw takes theta_m from the warp, not from an acos)."""
    out = {}
    if env is not None:
        out["sample_env"] = _near_pole(want["sample_env"][0] @ env.to_local.T, 1)
        out["eval_env"] = out["pdf_env"] = _near_pole(d @ env.to_local.T, 1)
    if brdf is not None:
        at_i = _near_pole(wi, 2)
        q = at_i | _near_pole(wi.double() + wo.double(), 2)
        for entry in BRDF_QUERIES:
            out[entry] = q
        out["sample_brdf"] = at_i
    return out


def row_gap(a: torch.Tensor, b: torch.Tensor, direction: bool) -> torch.Tensor:
    a, b = a.double().reshape(a.shape[0], -1), b.double().reshape(b.shape[0], -1)
    g = (a - b).abs() if direction else (a - b).abs() / b.abs().clamp(min=1e-6)
    return g.amax(-1)


def warp_gaps(env, brdf, u, wi, wo, d) -> dict:
    """{entry: {"max_gap" and "over_tol" over the rows that are neither a tie
    nor ill-conditioned, "tie_share", "tie_max_gap", "ill_share",
    "ill_max_gap", "bit_equal_share"}}: kernel against plain."""
    got, want = warp_calls(env, brdf, u, wi, wo, d, False), warp_calls(env, brdf, u, wi, wo, d, True)
    ties = warp_ties(env, brdf, u, wi, wo, d)
    ill = warp_ill_conditioned(env, brdf, wi, wo, d, want)
    out = {}
    for entry in got:
        a_s, b_s = [x if isinstance(x, tuple) else (x,) for x in (got[entry], want[entry])]
        gaps = torch.stack([row_gap(a, b, entry.startswith("sample") and i == 0)
                            for i, (a, b) in enumerate(zip(a_s, b_s))], -1).amax(-1)
        equal = torch.stack([(a == b).reshape(a.shape[0], -1).all(-1) for a, b in zip(a_s, b_s)], -1).all(-1)
        tie, bad = ties[entry], ill[entry] & ~ties[entry]
        held = ~(tie | bad)
        out[entry] = {"max_gap": float(gaps[held].max()), "over_tol": int((gaps[held] > WARP_TOL).sum()),
                      "tie_share": float(tie.double().mean()),
                      "tie_max_gap": float(gaps[tie].max()) if bool(tie.any()) else 0.0,
                      "ill_share": float(bad.double().mean()),
                      "ill_max_gap": float(gaps[bad].max()) if bool(bad.any()) else 0.0,
                      "bit_equal_share": float(equal.double().mean())}
    return out
