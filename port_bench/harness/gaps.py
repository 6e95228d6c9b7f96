"""The numbers the comparison with the reference reads: the widest gap
between the program's outputs and the reference's, absolute or relative
(against the reference's magnitude, floored at a millionth of its
largest), and the share of rows on which a discrete outcome differs."""

from __future__ import annotations

import torch


def abs_gap(a: torch.Tensor, b: torch.Tensor, mask=None) -> float:
    d = (a.float() - b.float()).abs()
    if d.ndim > 1:
        d = d.amax(dim=tuple(range(1, d.ndim)))
    if mask is not None:
        d = d[mask]
    return float(d.max()) if d.numel() else 0.0


def rel_gap(a: torch.Tensor, b: torch.Tensor, mask=None) -> float:
    a, b = a.float(), b.float()
    floor = 1e-6 * float(b.abs().max()) if b.numel() else 0.0
    d = (a - b).abs() / torch.clamp(b.abs(), min=max(floor, 1e-30))
    if d.ndim > 1:
        d = d.amax(dim=tuple(range(1, d.ndim)))
    if mask is not None:
        d = d[mask]
    return float(d.max()) if d.numel() else 0.0


def share(flags: torch.Tensor, among=None) -> float:
    if among is not None:
        flags = flags[among]
    return float(flags.float().mean()) if flags.numel() else 0.0


def row_rel(a: torch.Tensor, b: torch.Tensor, floor: float) -> torch.Tensor:
    """Per-row relative gap of (N, ...) tensors."""
    d = (a.float() - b.float()).abs() / torch.clamp(b.float().abs(), min=floor)
    return d.reshape(d.shape[0], -1).amax(-1)
