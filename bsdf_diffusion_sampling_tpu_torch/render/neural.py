"""Neural BSDF adapter (counterpart of the JAX package's
`render/neural.py`), for the disk, spherical and full-sphere domains.

- `neural_sample`: draw omega_o from the rectified flow given the local
  incident direction and turn the domain pdf into a solid-angle pdf. Disk:
  reject r^2 > 0.995, lift to the hemisphere, x cos theta_o. Spherical and
  full-sphere: (theta, phi) coordinates, reject sin theta <= 5e-5 and theta
  outside (0, pi/2) (spherical) or (0, pi) (full sphere), x the pole-guarded
  1/sin theta. Draws under a downward wi carry pdf 0.
- `neural_pdf`: the pdf of a given omega_o. Disk: the Newton inverse of the
  forward map with `pdf_exact` (the default), else reverse Euler. Spherical:
  with `pdf_exact` the same Newton inverse (K2s; the JAX package leaves
  `ode_pdf_exact` to XLA), else the K3 reverse transport times p0. The
  full-sphere pdf does not require wo_z > 0. A full-sphere sampler of K4's
  widths queries only the rows whose wi is above the surface (the others'
  pdf is 0), routed to the routed K2s as one group with no host sync.
- `neural_eval`: the ground-truth measured BRDF `brdf` (f * cos).

Sample and pdf run through the fused kernels of `ops/fused_ode.py` on the
card (K1/K2 disk, K4, K2s and K3 spherical; the in-kernel Philox draw when given
a `torch.Generator` or a seed), and through their plain versions for CPU
tensors. `neural_sample_routed` and `neural_pdf_routed` draw and query for
the rows of many full-sphere samplers at once, through the routed K4 and
K2s, each row with its own sampler's weights (`render/integrator.py` routes
a scene's matball rows to them).

All functions take LOCAL (shading-frame) directions, batched (N, 3).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from bsdf_diffusion_sampling_tpu_torch.bsdf.measured import MeasuredBRDF, eval_brdf
from bsdf_diffusion_sampling_tpu_torch.core import trace
from bsdf_diffusion_sampling_tpu_torch.core.config import ModelConfig, SamplerConfig
from bsdf_diffusion_sampling_tpu_torch.core.device import resolve_device
from bsdf_diffusion_sampling_tpu_torch.core.prng import RowSeed, draw_seed
from bsdf_diffusion_sampling_tpu_torch.geometry.coords import cart_to_spher, disk_to_cart, spher_to_cart
from bsdf_diffusion_sampling_tpu_torch.interop.jax_params import params_from_jax
from bsdf_diffusion_sampling_tpu_torch.models.base_density import get_base, spherical_draw, spherical_heads_from_enc
from bsdf_diffusion_sampling_tpu_torch.models.velocity import encode_condition
from bsdf_diffusion_sampling_tpu_torch.ops.fused_ode import (
    BASE_COLS,
    K4_NET,
    PackedWeights,
    StackedWeights,
    fused_pdf_disk,
    fused_pdf_spherical,
    fused_pdf_spherical_routed,
    fused_sample_pdf_disk,
    fused_sample_pdf_spherical,
    fused_sample_pdf_spherical_routed,
    fused_transport_packed,
    prepack_disk,
    prepack_spherical,
    route_rows,
    stack_packed,
)

DOMAINS = ("disk", "spherical", "sphere_full")


class NeuralBSDF(NamedTuple):
    domain: str  # "disk" | "spherical" | "sphere_full"
    cfg: ModelConfig
    v_params: list  # rectified velocity net
    base_params: dict
    brdf: MeasuredBRDF | None  # ground-truth eval
    T: int
    firefly_clamp: float
    packed: PackedWeights  # flat kernel weights, packed once here
    disk_valid_r2: float = 0.995
    pole_sin_eps: float = 5e-5
    pdf_exact: bool = True  # Newton exact-inverse pdf queries
    pdf_newton_iters: int = 2
    stack: StackedWeights | None = None  # `packed` alone, for the routed K2s (full sphere, K4's widths)


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
    measured BRDF move to `device`. The default is the card; pass
    device="cpu" for the plain versions."""
    device = resolve_device(device)
    if domain not in DOMAINS:
        raise ValueError(f"unknown domain {domain!r}; expected one of {DOMAINS}")
    v_params = params_from_jax(v_params, device)
    base_params = params_from_jax(base_params, device)
    base_params.setdefault("pe_bands", cfg.base_pe_bands)
    disk = domain == "disk"
    packed = prepack_disk(v_params, base_params) if disk else prepack_spherical(v_params, base_params)
    routed = domain == "sphere_full" and (packed.hidden, packed.layers) == K4_NET
    return NeuralBSDF(
        domain=domain,
        cfg=cfg,
        v_params=v_params,
        base_params=base_params,
        brdf=None if brdf is None else brdf.to(device),
        T=sampler_cfg.T_disk if disk else sampler_cfg.T_spherical,
        firefly_clamp=sampler_cfg.firefly_clamp_sphere if domain == "sphere_full" else sampler_cfg.firefly_clamp_disk,
        packed=packed,
        disk_valid_r2=sampler_cfg.disk_valid_r2,
        pole_sin_eps=sampler_cfg.pole_sin_eps,
        pdf_exact=sampler_cfg.pdf_exact,
        pdf_newton_iters=sampler_cfg.pdf_newton_iters,
        stack=stack_packed([packed]) if routed else None,
    )


def _wi_coords(nb: NeuralBSDF, wi_local: torch.Tensor) -> torch.Tensor:
    return wi_local[..., :2] if nb.domain == "disk" else cart_to_spher(wi_local)


def _sample_x_pdf(nb: NeuralBSDF, generator_or_eps, wi_local, cond):
    kernel = fused_sample_pdf_disk if nb.domain == "disk" else fused_sample_pdf_spherical
    if isinstance(generator_or_eps, torch.Generator):
        seed = draw_seed(generator_or_eps).to(wi_local.device)
        x, pdf, _ = kernel(nb.packed, cond, nb.T, seed=seed)
    elif isinstance(generator_or_eps, RowSeed):  # a shard of a larger wavefront
        x, pdf, _ = kernel(nb.packed, cond, nb.T, seed=generator_or_eps.seed, row0=generator_or_eps.row0)
    elif isinstance(generator_or_eps, tuple):  # spherical (eps_g, von Mises uniforms): phi0 drawn here
        eps_g, u_von = generator_or_eps
        phi0 = spherical_draw(spherical_heads_from_enc(nb.base_params, cond[..., :BASE_COLS]), eps_g, u_von)[..., 1]
        x, pdf, _ = kernel(nb.packed, cond, nb.T, eps=torch.stack([eps_g, phi0], dim=-1))
    elif generator_or_eps.dtype == torch.int64:
        x, pdf, _ = kernel(nb.packed, cond, nb.T, seed=generator_or_eps)
    else:
        x, pdf, _ = kernel(nb.packed, cond, nb.T, eps=generator_or_eps)
    return x, pdf


def _pole_jacobian(nb: NeuralBSDF, sin_t: torch.Tensor) -> torch.Tensor:
    """1/sin theta, pole-guarded (`brdf_measured_spherical.py:89-91`)."""
    return torch.clamp(1.0 / torch.clamp(sin_t, min=nb.pole_sin_eps), 0.0, 1e6)


def neural_sample(
    nb: NeuralBSDF, generator_or_eps, wi_local: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(wo_local, pdf_solid_angle). Invalid draws carry pdf 0.
    `generator_or_eps` is a `torch.Generator` (one kernel seed is drawn from
    it), a (1,) int64 kernel seed, a `RowSeed` (the seed of a shard whose
    first row is global row row0), or an (N, 2) tensor: standard normals
    (disk), or (standard normal for theta, von Mises phi) (spherical). A
    spherical sampler also takes an (eps_g (N,), u_von (16, 3, N)) pair and
    draws phi from the uniforms, as the JAX package draws from a key."""
    with trace.span("sampler.draw"):
        cond = encode_condition(_wi_coords(nb, wi_local), nb.cfg)
        x, pdf = _sample_x_pdf(nb, generator_or_eps, wi_local, cond)
        return _solid_angle_draw(nb, x, pdf, wi_local)


def _solid_angle_draw(nb: NeuralBSDF, x, pdf, wi_local):
    """(wo_local, pdf_solid_angle) of domain draws x with domain pdfs pdf."""
    if nb.domain == "disk":
        valid = (x * x).sum(-1) <= nb.disk_valid_r2  # `brdf_measured_disk.py:69-71`
        wo = disk_to_cart(x)
        pdf_sa = pdf * torch.clamp(wo[..., 2], min=0.0)  # `:82`
    else:
        theta = x[..., 0]
        sin_t = torch.sin(theta)
        # hemisphere for BRDFs, the full sphere for transmissive BSDFs
        theta_max = math.pi if nb.domain == "sphere_full" else math.pi / 2
        valid = (sin_t > nb.pole_sin_eps) & (theta > 0) & (theta < theta_max)
        wo = spher_to_cart(theta, x[..., 1])
        pdf_sa = pdf * _pole_jacobian(nb, sin_t)
    valid &= wi_local[..., 2] > 0
    return wo, torch.where(valid, torch.clamp(pdf_sa, min=0.0), 0.0)


def neural_sample_routed(nb: NeuralBSDF, sw: StackedWeights, seeds: torch.Tensor, rows: torch.Tensor,
                         tile_ball: torch.Tensor, wi_local: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """`neural_sample` of routed slots: slot s drawn by sampler
    tile_ball[s // ROUTE_TILE] of the stack `sw` (kernel seed seeds[ball])
    as K4 over the whole wavefront draws wavefront row rows[s]. `nb` is one
    of the stacked samplers: all share its domain (full sphere), widths, T
    and pole guard."""
    with trace.span("sampler.draw"):
        cond = encode_condition(_wi_coords(nb, wi_local), nb.cfg)
        x, pdf, _ = fused_sample_pdf_spherical_routed(sw, cond, rows, tile_ball, seeds, nb.T)
        return _solid_angle_draw(nb, x, pdf, wi_local)


def _pdf_query(nb: NeuralBSDF, x, omega_i, cond) -> torch.Tensor:
    """The domain-coordinate pdf of x."""
    if nb.domain == "disk":
        pdf, _ = fused_pdf_disk(nb.packed, x.contiguous(), cond, nb.T, exact=nb.pdf_exact,
                                newton_iters=nb.pdf_newton_iters)
        return pdf
    if nb.pdf_exact:  # K2s; the JAX package leaves this Newton solve to XLA
        pdf, _ = fused_pdf_spherical(nb.packed, x.contiguous(), cond, nb.T, newton_iters=nb.pdf_newton_iters)
        return pdf
    x0, det = fused_transport_packed(nb.packed, nb.domain, x.contiguous(), cond, nb.T, reverse=True)
    return torch.exp(get_base(nb.domain).log_prob(nb.base_params, x0, omega_i)) * det


def _query_point(nb: NeuralBSDF, wo_local):
    """(x, jac): the domain point of wo and its solid-angle jacobian."""
    if nb.domain == "disk":
        return wo_local[..., :2], torch.clamp(wo_local[..., 2], min=0.0)
    x = cart_to_spher(wo_local)
    return x, _pole_jacobian(nb, torch.sin(x[..., 0]))


def _solid_angle_pdf(nb: NeuralBSDF, pdf, jac, wi_local, wo_local):
    valid = wi_local[..., 2] > 0
    if nb.domain != "sphere_full":
        valid &= wo_local[..., 2] > 0
    return torch.where(valid, torch.clamp(pdf * jac, min=0.0), 0.0)


def neural_pdf(nb: NeuralBSDF, wi_local: torch.Tensor, wo_local: torch.Tensor) -> torch.Tensor:
    if nb.pdf_exact and nb.stack is not None:  # the rows above the surface alone: below it the pdf is 0
        rt = route_rows(torch.where(wi_local[..., 2] > 0, 0, -1), 1, "rows.routed_pdf")
        pdf = neural_pdf_routed(nb, nb.stack, rt.tile_ball, rt.gather(wi_local), rt.gather(wo_local))
        return rt.scatter(pdf, pdf.new_zeros(()))
    with trace.span("sampler.pdf"):
        omega_i = _wi_coords(nb, wi_local)
        cond = encode_condition(omega_i, nb.cfg)
        x, jac = _query_point(nb, wo_local)
        pdf = _pdf_query(nb, x, omega_i, cond)
        return _solid_angle_pdf(nb, pdf, jac, wi_local, wo_local)


def neural_pdf_routed(nb: NeuralBSDF, sw: StackedWeights, tile_ball: torch.Tensor, wi_local: torch.Tensor,
                      wo_local: torch.Tensor) -> torch.Tensor:
    """`neural_pdf` of routed slots by the routed K2s (the exact pdf), slot s
    under sampler tile_ball[s // ROUTE_TILE] of the stack `sw`; `nb` as for
    `neural_sample_routed`, with `pdf_exact`."""
    with trace.span("sampler.pdf"):
        cond = encode_condition(_wi_coords(nb, wi_local), nb.cfg)
        x, jac = _query_point(nb, wo_local)
        pdf, _ = fused_pdf_spherical_routed(sw, x.contiguous(), cond, tile_ball, nb.T,
                                            newton_iters=nb.pdf_newton_iters)
        return _solid_angle_pdf(nb, pdf, jac, wi_local, wo_local)


def neural_eval(nb: NeuralBSDF, wi_local: torch.Tensor, wo_local: torch.Tensor) -> torch.Tensor:
    """(N, 3) ground-truth measured f * cos (`brdf_measured_disk.py:103-110`)."""
    return eval_brdf(nb.brdf, wi_local, wo_local)


def firefly_filter(nb: NeuralBSDF, weight_rgb: torch.Tensor) -> torch.Tensor:
    """Zero the sample when luminance(f/pdf) exceeds the clamp
    (`brdf_measured_disk.py:97-100`)."""
    from bsdf_diffusion_sampling_tpu_torch.render.integrator import luminance_clamp

    return luminance_clamp(weight_rgb, nb.firefly_clamp)
