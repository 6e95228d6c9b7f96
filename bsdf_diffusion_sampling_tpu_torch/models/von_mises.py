"""Von Mises distribution on the circle: sampler and log-density
(counterpart of the JAX package's `models/von_mises.py`).

Sampling is Best-Fisher (1979) wrapped-Cauchy rejection with a fixed 16
proposal rounds drawn up front and the first accepted round kept. When no
round accepts (probability < 1e-7 a sample), round 0's angle is kept, as
the JAX function's argmax over an all-False mask does. The result is
wrapped to [-pi, pi) by a floor mod (`torch.remainder`, as `jnp.mod`).

log_prob is kappa cos(x - loc) - log(2 pi I0(kappa)) with the Abramowitz &
Stegun 9.8.1/9.8.2 polynomial pair for log I0.
"""

from __future__ import annotations

import math

import torch

N_ROUNDS = 16
U_LO, U_HI = 1e-7, 1.0 - 1e-7  # the uniforms' range

# A&S 9.8.1: I0(x) for |x| <= 3.75, polynomial in t = (x/3.75)^2
I0_SMALL = (1.0, 3.5156229, 3.0899424, 1.2067492, 0.2659732, 0.0360768, 0.0045813)
# A&S 9.8.2: exp(-x) sqrt(x) I0(x) for x >= 3.75, polynomial in t = 3.75/x
I0_LARGE = (0.39894228, 0.01328592, 0.00225319, -0.00157565, 0.00916281, -0.02057706, 0.02635537,
            -0.01647633, 0.00392377)


def _polyval(coeffs, t: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(t)
    for c in reversed(coeffs):
        out = out * t + c
    return out


def log_i0(x: torch.Tensor) -> torch.Tensor:
    """log I0(x), stable for x up to ~1e4."""
    x = x.abs()
    small = torch.log(_polyval(I0_SMALL, (x / 3.75) ** 2))
    xs = torch.clamp(x, min=1e-6)  # guard x = 0 in the unused large branch
    large = xs - 0.5 * torch.log(xs) + torch.log(_polyval(I0_LARGE, 3.75 / xs))
    return torch.where(x <= 3.75, small, large)


def von_mises_log_prob(x: torch.Tensor, loc: torch.Tensor, concentration: torch.Tensor) -> torch.Tensor:
    return concentration * torch.cos(x - loc) - math.log(2.0 * math.pi) - log_i0(concentration)


def von_mises_uniforms(gen: torch.Generator, shape, device=None) -> torch.Tensor:
    """(16, 3, *shape) uniforms in [1e-7, 1 - 1e-7] from a generator."""
    u = torch.rand((N_ROUNDS, 3) + tuple(shape), generator=gen, device=device or gen.device)
    return u * (U_HI - U_LO) + U_LO


def von_mises_sample(u, loc: torch.Tensor, concentration: torch.Tensor) -> torch.Tensor:
    """One von Mises draw per (loc, concentration) element, wrapped to
    [-pi, pi). `u` is a (16, 3, *shape) tensor of uniforms (round, role) or
    a `torch.Generator` to draw them from."""
    loc, kappa = torch.broadcast_tensors(loc, concentration)
    kappa = torch.clamp(kappa, min=1e-12)
    if isinstance(u, torch.Generator):
        u = von_mises_uniforms(u, kappa.shape, kappa.device)

    tau = 1.0 + torch.sqrt(1.0 + 4.0 * kappa * kappa)
    rho = (tau - torch.sqrt(2.0 * tau)) / (2.0 * kappa)
    r = (1.0 + rho * rho) / (2.0 * rho)

    z = torch.cos(math.pi * u[:, 0])
    f = (1.0 + r * z) / (r + z)
    c = kappa * (r - f)
    accept = ((c * (2.0 - c) - u[:, 1]) > 0.0) | ((torch.log(c / u[:, 1]) + 1.0 - c) >= 0.0)
    theta = torch.sign(u[:, 2] - 0.5) * torch.arccos(torch.clamp(f, -1.0, 1.0))

    idx = torch.argmax(accept.to(torch.uint8), dim=0)  # the first accepted round; 0 if none
    out = torch.gather(theta, 0, idx[None])[0] + loc
    out = torch.remainder(out + math.pi, 2.0 * math.pi) - math.pi
    uniform = u[0, 0] * 2.0 * math.pi - math.pi  # kappa ~ 0: uniform on the circle
    return torch.where(kappa < 1e-6, uniform, out)
