"""RGL measured-BRDF evaluator (Dupuy & Jakob 2018 parameterization),
counterpart of the JAX package's `bsdf/measured.py`.

Data model (per .bsdf tensor file):
  phi_i   (Pp,)          incidence azimuth grid; Pp = 1 for isotropic files
  theta_i (T,)           incidence grid
  sigma   (2, W)         projected microfacet area sigma(wi), lookup table
  ndf     (2, W)         microfacet NDF D(wm), lookup table
  vndf    (Pp, T, H, W)  visible-NDF warp over u_wm = (theta2u(th_m),
                         phi2u(phi_m - phi_i)), per (phi_i, theta_i)
  luminance (Pp, T, h, w) sampling density over the vndf-warped unit square
  rgb     (Pp, T, 3, h, w) measured BRDF ratio tables
Anisotropic files (Pp > 1) flatten the slices phi-major and blend the 4
bracketing (phi_i, theta_i) slices bilinearly; isotropic ones blend the 2
bracketing theta_i slices.

Mappings (square-root elevation spacing): u = theta2u(th) = sqrt(2 th / pi),
u2theta(u) = u^2 pi/2, phi2u(phi) = phi/(2 pi) + 0.5.

Evaluation chain (wi, wo upward):
  wm = normalize(wi + wo);  u_wm = (theta2u(th_m), phi2u(phi_m - phi_i))
  (s, vndf_pdf) = vndf.invert(u_wm | theta_i)
  f        = rgb[s] * D(u_wm) / (4 sigma(u_wi))        # includes cos(th_o)
  pdf(wo)  = vndf_pdf * lum_pdf(s) / (4 |wo.wm| * 2 pi^2 u_x sin th_m)
  sample(u): s = lum.sample(u); u_wm = vndf.sample(s); reflect(wi, wm)

The JAX package's TPU layouts of the same tables (`rgb_rows`, one-hot
lane selects) are not carried over: lookups here are plain gathers.

`eval_brdf`, `pdf_brdf`, `eval_pdf_brdf`, `eval_lum` and `sample_brdf`
launch one kernel of `ops/warp2d.py` for CUDA tensors and run their plain
versions (`*_plain`) for CPU ones; each adds the rows it computes to the
counter `rows.warp_brdf` while spans record.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from bsdf_diffusion_sampling_tpu_torch.bsdf.marginal2d import (
    Warp2D,
    build_warp2d,
    build_warp2d_aniso,
    slice_weights,
    warp_eval,
    warp_invert,
    warp_sample,
)
from bsdf_diffusion_sampling_tpu_torch.bsdf.tensorfile import read_tensor_file
from bsdf_diffusion_sampling_tpu_torch.core import trace
from bsdf_diffusion_sampling_tpu_torch.core.device import resolve_device
from bsdf_diffusion_sampling_tpu_torch.ops import warp2d

_TWO_OVER_PI = 2.0 / math.pi


def theta2u(theta):
    return torch.sqrt(torch.clamp(theta * _TWO_OVER_PI, min=0.0))


def u2theta(u):
    return u * u * (math.pi / 2.0)


def phi2u(phi):
    return phi / (2.0 * math.pi) + 0.5


def u2phi(u):
    return (u - 0.5) * (2.0 * math.pi)


def rgb_to_luminance(rgb):
    """Rec.709 luminance."""
    return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]


class MeasuredBRDF(NamedTuple):
    theta_i_grid: torch.Tensor  # (T,)
    sigma: torch.Tensor  # (2, W) lookup
    ndf: torch.Tensor  # (2, W) lookup
    vndf: Warp2D
    luminance: Warp2D
    rgb: torch.Tensor  # (Pp * T, 3, h, w), slices phi-major
    # the phi_i grid (Pp,) of an anisotropic file, None for an isotropic one
    phi_i_grid: Optional[torch.Tensor] = None
    name: str = ""

    def to(self, device) -> "MeasuredBRDF":
        return self._replace(theta_i_grid=self.theta_i_grid.to(device), sigma=self.sigma.to(device),
                             ndf=self.ndf.to(device), vndf=self.vndf.to(device),
                             luminance=self.luminance.to(device), rgb=self.rgb.to(device),
                             phi_i_grid=None if self.phi_i_grid is None else self.phi_i_grid.to(device))


def measured_from_tensors(tf, name: str = "", device="cuda") -> MeasuredBRDF:
    """Build the evaluator from raw RGL tensor-file entries, on `device` (the
    card by default; pass device="cpu" for the CPU)."""
    device = resolve_device(device)
    theta_i = np.array(tf["theta_i"], np.float32)
    phi_i = np.array(tf["phi_i"], np.float32)
    vndf_g = np.asarray(tf["vndf"], np.float64)
    lum_g = np.asarray(tf["luminance"], np.float64)
    rgb = np.array(tf["rgb"], np.float32)  # (Pp, T, 3, h, w)
    aniso = phi_i.shape[0] > 1
    if aniso:
        vndf, lum = build_warp2d_aniso(vndf_g, theta_i, phi_i), build_warp2d_aniso(lum_g, theta_i, phi_i)
    else:
        vndf, lum = build_warp2d(vndf_g[0], theta_i), build_warp2d(lum_g[0], theta_i)

    def f32(key):
        return torch.from_numpy(np.array(tf[key], np.float32))

    return MeasuredBRDF(
        theta_i_grid=torch.from_numpy(theta_i),
        sigma=f32("sigma"),
        ndf=f32("ndf"),
        vndf=vndf,
        luminance=lum,
        rgb=torch.from_numpy(np.ascontiguousarray(rgb.reshape((-1,) + rgb.shape[2:]))),
        phi_i_grid=torch.from_numpy(phi_i) if aniso else None,
        name=name,
    ).to(device)


def load_measured(path: str, device="cuda") -> MeasuredBRDF:
    device = resolve_device(device)
    return measured_from_tensors(read_tensor_file(path), name=path.rsplit("/", 1)[-1].removesuffix(".bsdf"),
                                 device=device)


def _lookup_2d(table: torch.Tensor, u_x, u_y):
    """Bilinear lookup of a (Hy, Wx) vertex table at unit coords."""
    Hy, Wx = table.shape
    xf = torch.clamp(u_x * (Wx - 1), 0.0, Wx - 1 - 1e-6)
    yf = torch.clamp(u_y * (Hy - 1), 0.0, Hy - 1 - 1e-6)
    x0, y0 = xf.to(torch.int64), yf.to(torch.int64)
    fx, fy = xf - x0, yf - y0
    # corner indices clamped as a JAX gather clamps them (weight 0 there)
    x1, y1 = torch.clamp(x0 + 1, max=Wx - 1), torch.clamp(y0 + 1, max=Hy - 1)
    return (table[y0, x0] * (1 - fx) * (1 - fy) + table[y0, x1] * fx * (1 - fy)
            + table[y1, x0] * (1 - fx) * fy + table[y1, x1] * fx * fy)


def _rgb_lookup(brdf: MeasuredBRDF, s: torch.Tensor, theta_i, phi_i):
    """(N, 3) rgb table value at unit-square s, interpolated over theta_i
    (and phi_i for anisotropic files)."""
    _, _, h, w = brdf.rgb.shape
    xf = torch.clamp(s[..., 0] * (w - 1), 0.0, w - 1 - 1e-6)
    yf = torch.clamp(s[..., 1] * (h - 1), 0.0, h - 1 - 1e-6)
    x0, y0 = xf.to(torch.int64), yf.to(torch.int64)
    fx, fy = (xf - x0)[..., None], (yf - y0)[..., None]
    x1, y1 = torch.clamp(x0 + 1, max=w - 1), torch.clamp(y0 + 1, max=h - 1)
    out = None
    for p, pw in slice_weights(brdf.theta_i_grid, brdf.phi_i_grid, theta_i, phi_i):
        c = [brdf.rgb[p, :, yy, xx] for yy, xx in ((y0, x0), (y0, x1), (y1, x0), (y1, x1))]
        v = c[0] * (1 - fx) * (1 - fy) + c[1] * fx * (1 - fy) + c[2] * (1 - fx) * fy + c[3] * fx * fy
        v = pw[..., None] * v
        out = v if out is None else out + v
    return out


def _spherical(w):
    theta = torch.arccos(torch.clamp(w[..., 2], -1.0, 1.0))
    phi = torch.atan2(w[..., 1], w[..., 0])
    return theta, phi


def _half_vector(wi, wo):
    h = wi + wo
    return h / torch.clamp(torch.linalg.vector_norm(h, dim=-1, keepdim=True), min=1e-12)


def _u_wm(theta_m, phi_m, phi_i):
    u_x = theta2u(theta_m)
    u_y = phi2u(phi_m - phi_i)
    return u_x, u_y - torch.floor(u_y)  # wrap to [0, 1)


def _solid_angle_jacobian(u_x, theta_m, wo, wm):
    """|d omega_o / d u_wm| = 4 |wo.wm| * 2 pi^2 u_x sin(theta_m)."""
    dot = (wo * wm).sum(-1).abs()
    return 4.0 * dot * torch.clamp(2.0 * math.pi ** 2 * u_x * torch.sin(theta_m), min=1e-6)


def _query(brdf: MeasuredBRDF, wi, wo):
    """What eval and pdf share: the active mask, the half-vector's warp
    coordinates and the vndf invert."""
    active = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    wm = _half_vector(wi, wo)
    theta_i, phi_i = _spherical(wi)
    theta_m, phi_m = _spherical(wm)
    u_x, u_y = _u_wm(theta_m, phi_m, phi_i)
    s, vndf_pdf = warp_invert(brdf.vndf, torch.stack([u_x, u_y], dim=-1), theta_i, phi_i)
    return active, wm, theta_i, phi_i, theta_m, u_x, u_y, s, vndf_pdf


def _f(brdf, active, theta_i, phi_i, u_x, u_y, s):
    fr = _rgb_lookup(brdf, s, theta_i, phi_i)
    d = _lookup_2d(brdf.ndf, u_x, u_y)
    sig = _lookup_2d(brdf.sigma, theta2u(theta_i), phi2u(phi_i))
    fr = torch.clamp(fr * (d / torch.clamp(4.0 * sig, min=1e-12))[..., None], min=0.0)
    return torch.where(active[..., None], fr, 0.0)


def _pdf(brdf, active, wo, wm, theta_i, phi_i, theta_m, u_x, s, vndf_pdf):
    lum_pdf = warp_eval(brdf.luminance, s, theta_i, phi_i)
    return torch.where(active, vndf_pdf * lum_pdf / _solid_angle_jacobian(u_x, theta_m, wo, wm), 0.0)


def _count(a: torch.Tensor, b: torch.Tensor) -> None:
    trace.count("rows.warp_brdf", max(a.numel() // a.shape[-1], b.numel() // b.shape[-1]))


def eval_brdf(brdf: MeasuredBRDF, wi: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """(N, 3) BSDF value * cos(theta_o); zero outside the upper hemisphere."""
    _count(wi, wo)
    if wi.device.type == "cuda":
        return warp2d.eval_brdf(brdf, wi, wo)
    return eval_brdf_plain(brdf, wi, wo)


def eval_brdf_plain(brdf: MeasuredBRDF, wi: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    active, wm, theta_i, phi_i, theta_m, u_x, u_y, s, _ = _query(brdf, wi, wo)
    return _f(brdf, active, theta_i, phi_i, u_x, u_y, s)


def pdf_brdf(brdf: MeasuredBRDF, wi: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """Solid-angle pdf of wo under sample_brdf."""
    _count(wi, wo)
    if wi.device.type == "cuda":
        return warp2d.pdf_brdf(brdf, wi, wo)
    return pdf_brdf_plain(brdf, wi, wo)


def pdf_brdf_plain(brdf: MeasuredBRDF, wi: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    active, wm, theta_i, phi_i, theta_m, u_x, _, s, vndf_pdf = _query(brdf, wi, wo)
    return _pdf(brdf, active, wo, wm, theta_i, phi_i, theta_m, u_x, s, vndf_pdf)


def eval_pdf_brdf(brdf: MeasuredBRDF, wi: torch.Tensor, wo: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(eval, pdf) in one pass, sharing the vndf invert; equals
    (eval_brdf(..), pdf_brdf(..)) exactly."""
    _count(wi, wo)
    if wi.device.type == "cuda":
        return warp2d.eval_pdf_brdf(brdf, wi, wo)
    return eval_pdf_brdf_plain(brdf, wi, wo)


def eval_pdf_brdf_plain(brdf: MeasuredBRDF, wi: torch.Tensor, wo: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    active, wm, theta_i, phi_i, theta_m, u_x, u_y, s, vndf_pdf = _query(brdf, wi, wo)
    return (_f(brdf, active, theta_i, phi_i, u_x, u_y, s),
            _pdf(brdf, active, wo, wm, theta_i, phi_i, theta_m, u_x, s, vndf_pdf))


def sample_brdf(brdf: MeasuredBRDF, u: torch.Tensor, wi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Importance-sample wo given wi and uniforms u (N, 2). Returns (wo, pdf);
    invalid (downward) results carry pdf 0."""
    _count(u, wi)
    if wi.device.type == "cuda":
        return warp2d.sample_brdf(brdf, u, wi)
    return sample_brdf_plain(brdf, u, wi)


def sample_brdf_plain(brdf: MeasuredBRDF, u: torch.Tensor, wi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    theta_i, phi_i = _spherical(wi)
    s, lum_pdf = warp_sample(brdf.luminance, u, theta_i, phi_i)
    u_wm, vndf_pdf = warp_sample(brdf.vndf, s, theta_i, phi_i)
    theta_m = u2theta(u_wm[..., 0])
    phi_m = u2phi(u_wm[..., 1]) + phi_i
    st, ct = torch.sin(theta_m), torch.cos(theta_m)
    wm = torch.stack([st * torch.cos(phi_m), st * torch.sin(phi_m), ct], dim=-1)
    wo = 2.0 * (wi * wm).sum(-1, keepdim=True) * wm - wi
    pdf = vndf_pdf * lum_pdf / _solid_angle_jacobian(u_wm[..., 0], theta_m, wo, wm)
    valid = (wo[..., 2] > 0) & (wi[..., 2] > 0)
    return wo, torch.where(valid, pdf, 0.0)


def eval_lum(brdf: MeasuredBRDF, wi: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """Luminance of eval_brdf, the scalar target density of the MCMC
    dataset generator."""
    _count(wi, wo)
    if wi.device.type == "cuda":
        return warp2d.eval_lum(brdf, wi, wo)
    return eval_lum_plain(brdf, wi, wo)


def eval_lum_plain(brdf: MeasuredBRDF, wi: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    return rgb_to_luminance(eval_brdf_plain(brdf, wi, wo))
