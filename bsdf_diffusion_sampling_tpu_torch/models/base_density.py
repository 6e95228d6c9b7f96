"""Conditional base densities p0(x | omega_i) (counterpart of the JAX
package's `models/base_density.py`).

- disk: a diagonal 2-D Gaussian whose heads (loc2, log_scale2) come from a
  biased 1x16 SiLU MLP over PE(omega_i, 3 bands).
- spherical (also the full-sphere domain's): a Gaussian over theta times a
  von Mises over phi, heads (loc, log_scale, loc_von, softplus(conc) +
  1e-3) from the same MLP shape. The trained quirk is kept: theta is drawn
  with scale exp(log_scale) + 1e-3 but normalised by -log_scale, the
  density the checkpoints were trained under.

Params are `{"net": [layer0, layer1], "pe_bands": int}`; the band count,
which the JAX package carries as a `Static` in the pytree, is a plain int
here.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from bsdf_diffusion_sampling_tpu_torch.models.encoding import encoded_dim, positional_encoding
from bsdf_diffusion_sampling_tpu_torch.models.mlp import init_mlp, mlp_apply
from bsdf_diffusion_sampling_tpu_torch.models.von_mises import von_mises_log_prob, von_mises_sample

_LOG_2PI = math.log(2.0 * math.pi)
EPS_SPHERICAL = 1e-3  # added to softplus(conc) and to exp(log_scale)


class BaseDensity(NamedTuple):
    """Bundles the pure functions for one base-density family."""

    domain: str
    init: callable
    sample: callable
    log_prob: callable


def _base_init(gen: torch.Generator, hidden: int = 16, pe_bands: int = 3) -> dict:
    """The heads' MLP [PE(omega_i, pe_bands), hidden, 4] with biases, from
    `gen`; both families share the shape."""
    return {"net": init_mlp(gen, [encoded_dim(2, pe_bands), hidden, 4], bias=True), "pe_bands": pe_bands}


disk_base_init = spherical_base_init = _base_init


def disk_heads_from_enc(params: dict, enc: torch.Tensor):
    """(loc, log_scale), each (N, 2), from an already encoded omega_i."""
    out = mlp_apply(params["net"], enc)
    return out[..., :2], out[..., 2:]


def _disk_heads(params: dict, omega_i: torch.Tensor):
    return disk_heads_from_enc(params, positional_encoding(omega_i, params["pe_bands"]))


def disk_base_sample(params: dict, omega_i: torch.Tensor, eps) -> torch.Tensor:
    """x0 = loc + eps * exp(log_scale). `eps` is an (N, 2) tensor of
    standard normals or a `torch.Generator` to draw them from."""
    loc, log_scale = _disk_heads(params, omega_i)
    if isinstance(eps, torch.Generator):
        eps = torch.randn(loc.shape, generator=eps, dtype=loc.dtype, device=loc.device)
    return loc + eps * torch.exp(log_scale)


def disk_log_prob_from_heads(loc, log_scale, x: torch.Tensor) -> torch.Tensor:
    z = (x - loc) / torch.exp(log_scale)
    return -_LOG_2PI - log_scale.sum(-1) - 0.5 * (z * z).sum(-1)


def disk_base_log_prob(params: dict, x: torch.Tensor, omega_i: torch.Tensor) -> torch.Tensor:
    loc, log_scale = _disk_heads(params, omega_i)
    return disk_log_prob_from_heads(loc, log_scale, x)


def spherical_heads_from_enc(params: dict, enc: torch.Tensor):
    """(loc, log_scale, loc_von, conc), each (N,), from an already encoded
    omega_i."""
    out = mlp_apply(params["net"], enc)
    conc = torch.nn.functional.softplus(out[..., 3]) + EPS_SPHERICAL
    return out[..., 0], out[..., 1], out[..., 2], conc


def _spherical_heads(params: dict, omega_i: torch.Tensor):
    return spherical_heads_from_enc(params, positional_encoding(omega_i, params["pe_bands"]))


def spherical_draw(heads, eps_g: torch.Tensor, u_von) -> torch.Tensor:
    """x0 = (theta, phi) from the heads, Gaussian eps_g (N,) and the von
    Mises uniforms (16, 3, N) (or a generator for them)."""
    loc, log_scale, loc_von, conc = heads
    theta = loc + eps_g * (torch.exp(log_scale) + EPS_SPHERICAL)
    return torch.stack([theta, von_mises_sample(u_von, loc_von, conc)], dim=-1)


def spherical_base_sample(params: dict, omega_i: torch.Tensor, eps) -> torch.Tensor:
    """x0 = (theta, phi). `eps` is an (eps_g (N,), u_von (16, 3, N)) pair,
    what the JAX package draws from a key, or a `torch.Generator`."""
    heads = _spherical_heads(params, omega_i)
    if isinstance(eps, torch.Generator):
        eps_g = torch.randn(heads[0].shape, generator=eps, dtype=heads[0].dtype, device=heads[0].device)
        return spherical_draw(heads, eps_g, eps)
    return spherical_draw(heads, *eps)


def spherical_log_prob_from_heads(heads, x: torch.Tensor) -> torch.Tensor:
    loc, log_scale, loc_von, conc = heads
    z = (x[..., 0] - loc) / (torch.exp(log_scale) + EPS_SPHERICAL)
    loggau = -0.5 * _LOG_2PI - log_scale - 0.5 * z * z
    return loggau + von_mises_log_prob(x[..., 1], loc_von, conc)


def spherical_base_log_prob(params: dict, x: torch.Tensor, omega_i: torch.Tensor) -> torch.Tensor:
    return spherical_log_prob_from_heads(_spherical_heads(params, omega_i), x)


DISK_BASE = BaseDensity("disk", disk_base_init, disk_base_sample, disk_base_log_prob)
SPHERICAL_BASE = BaseDensity("spherical", spherical_base_init, spherical_base_sample, spherical_base_log_prob)


def get_base(domain: str) -> BaseDensity:
    if domain == "disk":
        return DISK_BASE
    if domain in ("spherical", "sphere_full"):
        return SPHERICAL_BASE
    raise ValueError(f"unknown domain {domain!r}")
