"""Plain MLPs over parameter lists (counterpart of
the JAX package's `models/mlp.py`).

Parameters are a list of `{"w": (in, out)[, "b": (out,)]}` dicts of
tensors: the JAX layout `y = x @ W`, kept as is (no transpose), so the
fused kernels and the checkpoint converter see the same arrays as the JAX
package.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn.functional as F


def init_mlp(gen: torch.Generator, dims: Sequence[int], bias: bool = False) -> List[dict]:
    """Kaiming-uniform layers as `torch.nn.Linear` draws them (U(-b, b), b =
    1 / sqrt(fan_in), for the weights and the biases), on the generator's
    device. The stream is torch's, not `jax.random`'s."""
    params = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        bound = 1.0 / math.sqrt(d_in)
        layer = {"w": (torch.rand((d_in, d_out), generator=gen, device=gen.device) * 2.0 - 1.0) * bound}
        if bias:
            layer["b"] = (torch.rand((d_out,), generator=gen, device=gen.device) * 2.0 - 1.0) * bound
        params.append(layer)
    return params


def mlp_apply(params: List[dict], x: torch.Tensor, activation=F.silu) -> torch.Tensor:
    """SiLU-hidden MLP with a linear output layer; bias where a layer has one."""
    h = x
    for i, layer in enumerate(params):
        h = h @ layer["w"]
        if "b" in layer:
            h = h + layer["b"]
        if i + 1 < len(params):
            h = activation(h)
    return h


def mlp_dims(params: List[dict]) -> List[int]:
    return [params[0]["w"].shape[0]] + [layer["w"].shape[1] for layer in params]


def flatten_mlp(params: List[dict]) -> torch.Tensor:
    """All weights in one flat vector, layer by layer: w (row-major), then b
    where the layer has one."""
    leaves = []
    for layer in params:
        leaves.append(layer["w"].reshape(-1))
        if "b" in layer:
            leaves.append(layer["b"].reshape(-1))
    return torch.cat(leaves)
