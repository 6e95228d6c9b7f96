"""Few-step probability-flow ODE sampler with exact change-of-variables
pdfs (counterpart of the JAX package's `ode/flow.py:41-219`).

This module is the plain PyTorch reference that the fused kernels of
`ops/fused_ode.py` are held against. Each Euler step takes the velocity
and the two columns of dv/dx in forward mode (`torch.func.jvp`), as
`_velocity_and_jac` does with `jax.linearize`.

Invertibility contract: sampling DIVIDES by det(I + J/T) per forward step;
the reverse-Euler pdf query integrates backwards (alpha: 1 -> 0, x -= v/T)
and MULTIPLIES det(I - J/T); the exact query inverts each forward step
with a 2x2 Newton solve and DIVIDES by the forward dets at the recovered
points.

Det guard: the Newton solve replaces a step Jacobian det with
|det| <= 1e-20 by 1, as the fused kernel does
(the JAX package's `ops/fused_ode.py:925-926`). The JAX
`ode_pdf_exact` has no guard; the two differ only where it returns inf/nan.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from bsdf_diffusion_sampling_tpu_torch.geometry.coords import encode_spherical_x
from bsdf_diffusion_sampling_tpu_torch.models.base_density import get_base
from bsdf_diffusion_sampling_tpu_torch.models.velocity import velocity_apply

NEWTON_DET_GUARD = 1e-20


def _encode_x(domain: str, x: torch.Tensor) -> torch.Tensor:
    return x if domain == "disk" else encode_spherical_x(x)


def _velocity(domain, v_params, x, alpha, cond_enc) -> torch.Tensor:
    return velocity_apply(v_params, _encode_x(domain, x), alpha, cond_enc)


def _velocity_and_jac(
    domain: str,
    v_params: List[dict],
    x: torch.Tensor,
    alpha: float,
    cond_enc: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(v, j_col0, j_col1): the velocity and the columns J @ e0, J @ e1 of
    dv/dx, each (N, 2), by two forward-mode products."""

    def v_fn(x_):
        return _velocity(domain, v_params, x_, alpha, cond_enc)

    e0 = torch.zeros_like(x)
    e0[..., 0] = 1.0
    e1 = torch.zeros_like(x)
    e1[..., 1] = 1.0
    v, j_col0 = torch.func.jvp(v_fn, (x,), (e0,))
    _, j_col1 = torch.func.jvp(v_fn, (x,), (e1,))
    return v, j_col0, j_col1


def _step_det(j0: torch.Tensor, j1: torch.Tensor, h: float, sign: float) -> torch.Tensor:
    """det(I + sign*h*J) from Jacobian columns j0, j1."""
    a = 1.0 + sign * h * j0[..., 0]
    b = sign * h * j1[..., 0]
    c = sign * h * j0[..., 1]
    d = 1.0 + sign * h * j1[..., 1]
    return a * d - b * c


def transport_with_det(
    domain: str, v_params: List[dict], x: torch.Tensor, cond_enc: torch.Tensor,
    T: int, reverse: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """T Euler steps and the product of their step dets. Forward: alpha =
    t/T, x += v/T. Reverse: alpha = 1 - t/T, x -= v/T."""
    h = 1.0 / T
    sign = -1.0 if reverse else 1.0
    det_acc = torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
    for t in range(T):
        alpha = 1.0 - t * h if reverse else t * h
        v, j0, j1 = _velocity_and_jac(domain, v_params, x, alpha, cond_enc)
        det_acc = det_acc * _step_det(j0, j1, h, sign)
        x = x + sign * h * v
    return x, det_acc


def transport(
    domain: str, v_params: List[dict], x: torch.Tensor, cond_enc: torch.Tensor,
    T: int, reverse: bool = False,
) -> torch.Tensor:
    """`transport_with_det` without the det: T Euler steps of the velocity."""
    h = 1.0 / T
    sign = -1.0 if reverse else 1.0
    for t in range(T):
        alpha = 1.0 - t * h if reverse else t * h
        x = x + sign * h * _velocity(domain, v_params, x, alpha, cond_enc)
    return x


def newton_inverse(
    domain: str, v_params: List[dict], y: torch.Tensor, cond_enc: torch.Tensor,
    T: int, newton_iters: int = 2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Invert the forward Euler map: for t = T-1..0 solve y = x + h v(x, t/T)
    for x (reverse-Euler warm start, then `newton_iters` 2x2 Newton steps)
    and multiply det(I + h J) at the recovered x. Returns (x0, det_prod)."""
    h = 1.0 / T
    det_acc = torch.ones(y.shape[:-1], dtype=y.dtype, device=y.device)
    for t in range(T - 1, -1, -1):
        alpha = t * h
        x = y - h * _velocity(domain, v_params, y, alpha, cond_enc)
        for _ in range(newton_iters):
            v_x, j0, j1 = _velocity_and_jac(domain, v_params, x, alpha, cond_enc)
            f0 = x[..., 0] + h * v_x[..., 0] - y[..., 0]
            f1 = x[..., 1] + h * v_x[..., 1] - y[..., 1]
            a = 1.0 + h * j0[..., 0]
            b = h * j1[..., 0]
            c = h * j0[..., 1]
            d = 1.0 + h * j1[..., 1]
            det = a * d - b * c
            det = torch.where(det.abs() > NEWTON_DET_GUARD, det, torch.ones_like(det))
            dx0 = (d * f0 - b * f1) / det
            dx1 = (-c * f0 + a * f1) / det
            x = x - torch.stack([dx0, dx1], dim=-1)
        # det at the converged forward point: what the sampler multiplies
        _, j0, j1 = _velocity_and_jac(domain, v_params, x, alpha, cond_enc)
        det_acc = det_acc * _step_det(j0, j1, h, +1.0)
        y = x
    return y, det_acc


def ode_sample(
    domain: str,
    v_params: List[dict],
    base_params: dict,
    omega_i: torch.Tensor,
    cond_enc: torch.Tensor,
    T: int,
    *,
    eps=None,
    x0: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw x ~ p1(.|omega_i) and its exact pdf: x0 ~ base (from `eps`, the
    draw `get_base(domain).sample` takes, or a given `x0`), T Euler steps,
    pdf = p0(x0) / prod_t det(I + J_t/T)."""
    if (eps is None) == (x0 is None):
        raise ValueError("pass exactly one of eps and x0")
    base = get_base(domain)
    if x0 is None:
        x0 = base.sample(base_params, omega_i, eps)
    p0 = torch.exp(base.log_prob(base_params, x0, omega_i))
    x, det_acc = transport_with_det(domain, v_params, x0, cond_enc, T)
    return x, p0 / det_acc


def ode_pdf(
    domain: str,
    v_params: List[dict],
    base_params: dict,
    omega_o: torch.Tensor,
    omega_i: torch.Tensor,
    cond_enc: torch.Tensor,
    T: int,
) -> torch.Tensor:
    """pdf of a given omega_o by reverse Euler: p0(x0) * prod_t det(I - J_t/T)."""
    x0, det_acc = transport_with_det(domain, v_params, omega_o, cond_enc, T, reverse=True)
    return torch.exp(get_base(domain).log_prob(base_params, x0, omega_i)) * det_acc


def ode_sample_only(
    domain: str,
    v_params: List[dict],
    x0: torch.Tensor,
    cond_enc: torch.Tensor,
    T: int,
) -> torch.Tensor:
    """pdf-free T-step transport of given base samples."""
    return transport(domain, v_params, x0, cond_enc, T)


def ode_pdf_exact(
    domain: str,
    v_params: List[dict],
    base_params: dict,
    omega_o: torch.Tensor,
    omega_i: torch.Tensor,
    cond_enc: torch.Tensor,
    T: int,
    newton_iters: int = 2,
) -> torch.Tensor:
    """Exact-inverse pdf query: p0(x0) / prod_t det(I + J_t/T) at the points
    the Newton solve recovers (see `newton_inverse`)."""
    x0, det_acc = newton_inverse(domain, v_params, omega_o, cond_enc, T, newton_iters)
    return torch.exp(get_base(domain).log_prob(base_params, x0, omega_i)) / det_acc
