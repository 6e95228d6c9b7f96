"""Random weights at full width from the run's seed, made on the device in
one draw: Kaiming-uniform layers (U(-b, b), b = 1 / sqrt(fan_in), for
the weights and the biases), the velocity nets' weights scaled by 0.5 so
that the Euler maps stay invertible. Trees in the program's layout:
{"w": (in, out)[, "b": (out,)]} per layer."""

from __future__ import annotations

import math

import torch

V_SCALE = 0.5


def _spec(dims, bias: bool, scale: float):
    return [(a, b, bias, scale) for a, b in zip(dims[:-1], dims[1:])]


def velocity_dims(hidden: int, layers: int, x_enc: int) -> list:
    return [x_enc + 1 + 22] + [hidden] * layers + [2]


def make(seed: int, nets: dict, device) -> dict:
    """`nets`: name -> ("base", None) for the base heads' 14 -> 16 -> 4
    biased MLP, or ("velocity", dims) for a bias-free velocity net."""
    specs = {}
    for name, (kind, dims) in nets.items():
        specs[name] = _spec([14, 16, 4], True, 1.0) if kind == "base" else _spec(dims, False, V_SCALE)
    total = sum(a * b + (b if bias else 0) for s in specs.values() for a, b, bias, _ in s)
    gen = torch.Generator(device=device).manual_seed(int(seed) & ((1 << 63) - 1))
    u = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for name, spec in specs.items():
        layers = []
        for a, b, bias, scale in spec:
            bound = 1.0 / math.sqrt(a)
            layer = {"w": (u[at:at + a * b].view(a, b) * (bound * scale)).contiguous()}
            at += a * b
            if bias:
                layer["b"] = (u[at:at + b] * bound).contiguous()
                at += b
            layers.append(layer)
        out[name] = layers
    return out


def clone(tree):
    if isinstance(tree, list):
        return [clone(x) for x in tree]
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    return tree.detach().clone()
