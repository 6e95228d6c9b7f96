"""The three stages' losses (counterpart of the JAX package's
`train/losses.py`).

- pretrain: the mean negative log-likelihood of omega_o under the
  conditional base density;
- flow matching: x_alpha = (1 - alpha) x0 + alpha x1, regress v(x_alpha,
  alpha, omega_i) onto x1 - x0 by MSE. On the periodic domains x1's phi is
  first moved to the shortest arc from x0's phi, and the phi target is
  that wrapped difference.

alpha is the reference's linspace(0, 1, batch): with the batch drawn at
random, row i's alpha = i / (B - 1) is a stratified draw of alpha.
"""

from __future__ import annotations

from typing import List

import torch

from bsdf_diffusion_sampling_tpu_torch.core.device import resolve_device
from bsdf_diffusion_sampling_tpu_torch.geometry.coords import shortest_arc_delta
from bsdf_diffusion_sampling_tpu_torch.models.base_density import BaseDensity
from bsdf_diffusion_sampling_tpu_torch.models.velocity import velocity_apply
from bsdf_diffusion_sampling_tpu_torch.ode.flow import _encode_x


def pretrain_nll(base: BaseDensity, params: dict, batch: torch.Tensor) -> torch.Tensor:
    """batch: (N, 4) rows of (omega_i, omega_o)."""
    return -base.log_prob(params, batch[:, 2:4], batch[:, 0:2]).mean()


def flow_matching_targets(domain: str, x0: torch.Tensor, x1: torch.Tensor, alpha: torch.Tensor):
    """(x_alpha, v_target), phi taken on the shortest arc off the disk."""
    if domain != "disk":
        x1 = torch.stack([x1[:, 0], x0[:, 1] + shortest_arc_delta(x1[:, 1], x0[:, 1])], dim=-1)
    return (1.0 - alpha) * x0 + alpha * x1, x1 - x0


def flow_matching_mse(domain: str, v_params: List[dict], x0: torch.Tensor, x1: torch.Tensor, alpha: torch.Tensor,
                      cond_enc: torch.Tensor) -> torch.Tensor:
    x_alpha, v_target = flow_matching_targets(domain, x0, x1, alpha)
    pred = velocity_apply(v_params, _encode_x(domain, x_alpha), alpha, cond_enc)
    return ((pred - v_target) ** 2).mean()


def linspace_alpha(n: int, device="cuda") -> torch.Tensor:
    """The stratified alpha grid, shape (n, 1), float32, on `device` (the
    card by default; pass device="cpu" for the CPU)."""
    return torch.linspace(0.0, 1.0, n, dtype=torch.float32, device=resolve_device(device)).reshape(-1, 1)
