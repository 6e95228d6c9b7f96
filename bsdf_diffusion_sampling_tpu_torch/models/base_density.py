"""Conditional base density p0(x | omega_i), disk half (counterpart of
the JAX package's `models/base_density.py:48-72`).

Disk: a diagonal 2-D Gaussian whose heads (loc2, log_scale2) come from a
biased 1x16 SiLU MLP over PE(omega_i, 3 bands). Params are
`{"net": [layer0, layer1], "pe_bands": int}`; the band count, which the JAX
package carries as a `Static` in the pytree, is a plain int here. The
spherical family waits for a later slice of the port.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from bsdf_diffusion_sampling_tpu_torch.models.encoding import positional_encoding
from bsdf_diffusion_sampling_tpu_torch.models.mlp import mlp_apply

_LOG_2PI = math.log(2.0 * math.pi)


class BaseDensity(NamedTuple):
    """Bundles the pure functions for one base-density family."""

    domain: str
    sample: callable
    log_prob: callable


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


DISK_BASE = BaseDensity("disk", disk_base_sample, disk_base_log_prob)


def get_base(domain: str) -> BaseDensity:
    if domain == "disk":
        return DISK_BASE
    if domain in ("spherical", "sphere_full"):
        raise NotImplementedError(f"the {domain!r} base density is not ported yet")
    raise ValueError(f"unknown domain {domain!r}")
