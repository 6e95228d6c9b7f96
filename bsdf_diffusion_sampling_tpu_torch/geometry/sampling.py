"""Stratified samplers over the conditioning domains (counterpart of the
JAX package's `geometry/sampling.py`).

- `stratified_sampling_2d`: a jittered lattice over [0, 1)^2, the smallest
  side x side grid with side^2 >= n, cells randomly permuted and the first n
  jittered;
- `concentric_square_to_disk`: Shirley's concentric map [-1, 1]^2 -> disk.

Every draw comes from an explicit `torch.Generator`, on its device.
"""

from __future__ import annotations

import math

import torch


def stratified_sampling_2d(gen: torch.Generator, n: int) -> torch.Tensor:
    """Jittered-lattice stratified samples over [0, 1)^2, shape (n, 2): one
    point in each of n distinct cells of the side x side lattice."""
    side = math.isqrt(n)
    if side * side < n:
        side += 1
    dev = gen.device
    cell = torch.randperm(side * side, generator=gen, device=dev)[:n]
    uv = torch.stack([cell // side, cell % side], dim=-1).to(torch.float32) / side
    return uv + torch.rand((n, 2), generator=gen, device=dev) / side


def concentric_square_to_disk(uv: torch.Tensor) -> torch.Tensor:
    """Shirley's low-distortion concentric map [-1, 1]^2 -> unit disk; the
    origin maps to the origin, and on the diagonals (|x| = |y|) the y
    branch is taken."""
    x, y = uv[..., 0], uv[..., 1]
    zero = (x == 0) & (y == 0)
    safe_x = torch.where(x == 0, 1.0, x)  # avoid 0/0 in the unused branch
    safe_y = torch.where(y == 0, 1.0, y)
    use_x = x.abs() > y.abs()
    r = torch.where(use_x, x, y)
    theta = torch.where(use_x, (math.pi / 4.0) * (y / safe_x), (math.pi / 2.0) - (math.pi / 4.0) * (x / safe_y))
    out = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
    return torch.where(zero[..., None], 0.0, out)


def stratified_disk(gen: torch.Generator, n: int) -> torch.Tensor:
    """Stratified points on the unit disk: the concentric map of a jittered
    lattice."""
    return concentric_square_to_disk(stratified_sampling_2d(gen, n) * 2.0 - 1.0)


def stratified_hemisphere_angles(gen: torch.Generator, n: int, theta_max: float = math.pi / 2) -> torch.Tensor:
    """Stratified (theta, phi), theta in [0, theta_max), phi in [-pi, pi):
    uniform in angle space (pass theta_max = pi for the full sphere)."""
    uv = stratified_sampling_2d(gen, n)
    return torch.stack([uv[:, 0] * theta_max, uv[:, 1] * 2.0 * math.pi - math.pi], dim=-1)
