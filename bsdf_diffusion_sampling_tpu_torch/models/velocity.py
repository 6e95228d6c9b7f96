"""Conditional velocity networks v(x_alpha, alpha, omega_i) -> R^2
(counterpart of the JAX package's `models/velocity.py`).

Bias-free SiLU MLPs over [x_enc, alpha, PE(omega_i, 5 bands)]. The caller
encodes the condition once (`encode_condition`) and passes `cond_enc` to
every step.
"""

from __future__ import annotations

from typing import List

import torch

from bsdf_diffusion_sampling_tpu_torch.core.config import ModelConfig
from bsdf_diffusion_sampling_tpu_torch.models.encoding import positional_encoding
from bsdf_diffusion_sampling_tpu_torch.models.mlp import init_mlp, mlp_apply


def velocity_init(gen: torch.Generator, cfg: ModelConfig) -> List[dict]:
    """A bias-free net [velocity_in_dim, hidden x layers, 2] from `gen`."""
    return init_mlp(gen, [cfg.velocity_in_dim] + [cfg.velocity_hidden] * cfg.velocity_layers + [2], bias=False)


def encode_condition(omega_i: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return positional_encoding(omega_i, cfg.velocity_pe_bands)


def velocity_apply(
    params: List[dict],
    x_enc: torch.Tensor,
    alpha,
    cond_enc: torch.Tensor,
) -> torch.Tensor:
    """x_enc: (N, 2|3); alpha: (N, 1) tensor or a float; cond_enc: (N, 22)."""
    if not torch.is_tensor(alpha) or alpha.ndim == 0:
        alpha = torch.full(x_enc.shape[:-1] + (1,), float(alpha),
                           dtype=x_enc.dtype, device=x_enc.device)
    return mlp_apply(params, torch.cat([x_enc, alpha, cond_enc], dim=-1))
