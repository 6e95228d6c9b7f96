"""Neural BSDF adapter, disk domain (counterpart of the JAX package's
`render/neural.py:46-117,206-264`).

- `neural_sample`: draw omega_o from the rectified flow in disk coordinates
  given the local incident direction, reject draws outside the valid disk
  (r^2 > 0.995) or under a downward wi, lift to a direction, and turn the
  disk-area pdf into a solid-angle pdf (x cos theta_o).
- `neural_pdf`: the pdf of a given omega_o (x cos theta_o); with
  `pdf_exact` (the default) the Newton inverse of the forward map.
- `neural_eval`: the ground-truth measured BRDF `brdf` (f * cos).

Sample and pdf run through the fused kernels of `ops/fused_ode.py` on the
card (the in-kernel Philox draw when given a `torch.Generator` or a seed),
and through their plain versions for CPU tensors. The spherical domains
wait for a later slice of the port.

All functions take LOCAL (shading-frame) directions, batched (N, 3).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from bsdf_diffusion_sampling_tpu_torch.bsdf.measured import MeasuredBRDF, eval_brdf
from bsdf_diffusion_sampling_tpu_torch.core.config import ModelConfig, SamplerConfig
from bsdf_diffusion_sampling_tpu_torch.core.device import resolve_device
from bsdf_diffusion_sampling_tpu_torch.core.prng import draw_seed
from bsdf_diffusion_sampling_tpu_torch.geometry.coords import disk_to_cart
from bsdf_diffusion_sampling_tpu_torch.interop.jax_params import params_from_jax
from bsdf_diffusion_sampling_tpu_torch.models.velocity import encode_condition
from bsdf_diffusion_sampling_tpu_torch.ops.fused_ode import (
    DiskWeights,
    fused_pdf_disk,
    fused_sample_pdf_disk,
    prepack_disk,
)


class NeuralBSDF(NamedTuple):
    domain: str  # "disk"
    cfg: ModelConfig
    v_params: list  # rectified velocity net
    base_params: dict
    brdf: MeasuredBRDF | None  # ground-truth eval
    T: int
    firefly_clamp: float
    packed: DiskWeights  # flat kernel weights, packed once here
    disk_valid_r2: float = 0.995
    pdf_exact: bool = True  # Newton exact-inverse pdf queries
    pdf_newton_iters: int = 2


def make_neural_bsdf(
    domain: str,
    cfg: ModelConfig,
    v_params,
    base_params,
    brdf=None,
    sampler_cfg: SamplerConfig = SamplerConfig(),
    device="cuda",
) -> NeuralBSDF:
    """Weights (numpy arrays or tensors, in the JAX trees' layout) and the
    measured BRDF move to `device`. The default is the card; pass device="cpu" for the plain
    versions."""
    device = resolve_device(device)
    if domain != "disk":
        raise NotImplementedError(f"the {domain!r} neural BSDF is not ported yet")
    v_params = params_from_jax(v_params, device)
    base_params = params_from_jax(base_params, device)
    base_params.setdefault("pe_bands", cfg.base_pe_bands)
    return NeuralBSDF(
        domain=domain,
        cfg=cfg,
        v_params=v_params,
        base_params=base_params,
        brdf=None if brdf is None else brdf.to(device),
        T=sampler_cfg.T_disk,
        firefly_clamp=sampler_cfg.firefly_clamp_disk,
        packed=prepack_disk(v_params, base_params),
        disk_valid_r2=sampler_cfg.disk_valid_r2,
        pdf_exact=sampler_cfg.pdf_exact,
        pdf_newton_iters=sampler_cfg.pdf_newton_iters,
    )


def neural_sample(
    nb: NeuralBSDF, generator_or_eps, wi_local: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(wo_local, pdf_solid_angle). Invalid draws carry pdf 0.
    `generator_or_eps` is a `torch.Generator` (one kernel seed is drawn from
    it), a (1,) int64 kernel seed, or an (N, 2) tensor of standard normals."""
    cond = encode_condition(wi_local[..., :2], nb.cfg)
    if isinstance(generator_or_eps, torch.Generator):
        seed = draw_seed(generator_or_eps).to(wi_local.device)
        x, pdf, _ = fused_sample_pdf_disk(nb.packed, cond, nb.T, seed=seed)
    elif generator_or_eps.dtype == torch.int64:
        x, pdf, _ = fused_sample_pdf_disk(nb.packed, cond, nb.T, seed=generator_or_eps)
    else:
        x, pdf, _ = fused_sample_pdf_disk(nb.packed, cond, nb.T, eps=generator_or_eps)
    valid = (x * x).sum(-1) <= nb.disk_valid_r2  # `brdf_measured_disk.py:69-71`
    wo = disk_to_cart(x)
    pdf_sa = pdf * torch.clamp(wo[..., 2], min=0.0)  # `:82`
    valid &= wi_local[..., 2] > 0
    return wo, torch.where(valid, torch.clamp(pdf_sa, min=0.0), 0.0)


def neural_pdf(nb: NeuralBSDF, wi_local: torch.Tensor, wo_local: torch.Tensor) -> torch.Tensor:
    cond = encode_condition(wi_local[..., :2], nb.cfg)
    x = wo_local[..., :2].contiguous()
    jac = torch.clamp(wo_local[..., 2], min=0.0)
    pdf, _ = fused_pdf_disk(nb.packed, x, cond, nb.T, exact=nb.pdf_exact,
                            newton_iters=nb.pdf_newton_iters)
    valid = (wi_local[..., 2] > 0) & (wo_local[..., 2] > 0)
    return torch.where(valid, torch.clamp(pdf * jac, min=0.0), 0.0)


def neural_eval(nb: NeuralBSDF, wi_local: torch.Tensor, wo_local: torch.Tensor) -> torch.Tensor:
    """(N, 3) ground-truth measured f * cos (`brdf_measured_disk.py:103-110`)."""
    return eval_brdf(nb.brdf, wi_local, wo_local)


def firefly_filter(nb: NeuralBSDF, weight_rgb: torch.Tensor) -> torch.Tensor:
    """Zero the sample when luminance(f/pdf) exceeds the clamp
    (`brdf_measured_disk.py:97-100`)."""
    lum = 0.2126 * weight_rgb[..., 0] + 0.7152 * weight_rgb[..., 1] + 0.0722 * weight_rgb[..., 2]
    return torch.where((lum < nb.firefly_clamp)[..., None], weight_rgb, 0.0)
