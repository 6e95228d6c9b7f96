"""Coordinate maps between the sampling domains and cartesian directions
(counterpart of the JAX package's `geometry/coords.py`).

- "disk": a direction's projection (x, y) onto the unit disk;
  z = sqrt(max(1 - x^2 - y^2, 0)) lifts it to the upper hemisphere.
- "spherical": (theta, phi) angles.

All functions are batched over the leading axes.
"""

from __future__ import annotations

import math

import torch


def disk_to_cart(wo: torch.Tensor) -> torch.Tensor:
    """Lift (N, 2) disk coordinates to (N, 3) upper-hemisphere directions."""
    rr = (wo[..., :2] ** 2).sum(-1, keepdim=True)
    z = torch.sqrt(torch.clamp(1.0 - rr, min=0.0))
    return torch.cat([wo[..., :2], z], dim=-1)


def cart_to_disk(w: torch.Tensor) -> torch.Tensor:
    """Project (N, 3) directions to (N, 2) disk coordinates."""
    return w[..., :2]


def spher_to_cart(theta: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """(theta, phi) -> unit (N, 3) direction (z = cos theta)."""
    st = torch.sin(theta)
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi), torch.cos(theta)], dim=-1)


def cart_to_spher(w: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(N, 3) direction -> (N, 2) (theta, phi); phi in (-pi, pi]."""
    r = torch.linalg.vector_norm(w, dim=-1)
    theta = torch.arccos(torch.clamp(w[..., 2] / (r + eps), -1.0, 1.0))
    phi = torch.atan2(w[..., 1], w[..., 0])
    return torch.stack([theta, phi], dim=-1)


def wrap_angle(phi: torch.Tensor) -> torch.Tensor:
    """Wrap angles to [-pi, pi) (a floor mod, as `jnp.mod`)."""
    return torch.remainder(phi + math.pi, 2.0 * math.pi) - math.pi


def shortest_arc_delta(phi_to: torch.Tensor, phi_from: torch.Tensor) -> torch.Tensor:
    """Signed shortest angular difference phi_to - phi_from in [-pi, pi): the
    flow-matching target on the periodic phi axis."""
    return wrap_angle(phi_to - phi_from)


def encode_spherical_x(x: torch.Tensor) -> torch.Tensor:
    """(theta, phi) -> (theta, sin phi, cos phi): the spherical nets' input."""
    return torch.stack([x[..., 0], torch.sin(x[..., 1]), torch.cos(x[..., 1])], dim=-1)
