"""NeRF-style frequency encoding (counterpart of
the JAX package's `models/encoding.py`).

Output layout is [x, sin(2^0 x), cos(2^0 x), sin(2^1 x), cos(2^1 x), ...],
each term spanning the input feature dim. Because the bands come in
increasing order, the first `2 * (2k + 1)` columns of a B-band encoding of a
2-vector equal its k-band encoding: the 14-column prefix of the 5-band
velocity condition IS the 3-band base-head input, which the fused kernels
rely on.
"""

from __future__ import annotations

import torch


def positional_encoding(x: torch.Tensor, num_bands: int, include_input: bool = True) -> torch.Tensor:
    if num_bands == 0:
        return x
    parts = [x] if include_input else []
    for i in range(num_bands):
        xf = x * float(2.0**i)
        parts.append(torch.sin(xf))
        parts.append(torch.cos(xf))
    return torch.cat(parts, dim=-1)


def encoded_dim(in_dim: int, num_bands: int, include_input: bool = True) -> int:
    return in_dim * (2 * num_bands + (1 if include_input else 0))
