"""The plain reference of the neural sampler: positional encoding, the
SiLU MLPs with forward-mode tangents written out, the conditional base
densities, Philox4x32-10 and its Box-Muller and Best-Fisher draws, and
the few-step Euler flow with its Jacobian determinant.

Float32 throughout. `Prec` says how the arithmetic rounds: `Prec()` is
float32 with TF32 off (what the configurations state); `Prec(low=True)`
is the control, the nets' products on TF32 operands (10-bit mantissas)
and, outside the nets, each piece's results rounded to bfloat16
(`Prec.q`), the nearest precisions below float32 there.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

LOG_2PI = math.log(2.0 * math.pi)


@dataclass(frozen=True)
class Prec:
    low: bool = False

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """x as the control's bfloat16 arithmetic would hold it."""
        return x.to(torch.bfloat16).to(x.dtype) if self.low and x.is_floating_point() else x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _TF32MatMul.apply(a, b) if self.low else a @ b


FP32 = Prec()
LOW = Prec(low=True)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, round to nearest)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """a @ b on TF32 operands, its two backward products too."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32(a) @ tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32(g)
        return g @ tf32(b).T, tf32(a).T @ g


def pe(x: torch.Tensor, bands: int) -> torch.Tensor:
    """[x, sin(x), cos(x), sin(2x), cos(2x), ...]."""
    parts = [x]
    for i in range(bands):
        parts += [torch.sin(x * 2.0 ** i), torch.cos(x * 2.0 ** i)]
    return torch.cat(parts, dim=-1)


def mlp(layers: list, h: torch.Tensor, tangents=(), prec: Prec = FP32, extra=None):
    """SiLU MLP over [{"w": (in, out), "b"?: (out,)}] with its linear last
    layer; `tangents` are pushed forward beside the primal. `extra`, where
    given, is added to the first layer's product: the part of it that the
    first layer's last input rows give (a condition constant over steps)."""
    ts = list(tangents)
    for i, layer in enumerate(layers):
        w = layer["w"]
        if i == 0 and extra is not None:
            w = w[:h.shape[1]]
        h = prec.mm(h, w)
        if i == 0 and extra is not None:
            h = h + extra
        if "b" in layer:
            h = h + layer["b"]
        ts = [prec.mm(t, w) for t in ts]
        if i + 1 < len(layers):
            s = torch.sigmoid(h)
            if ts:
                ds = s * (1.0 + h * (1.0 - s))
                ts = [t * ds for t in ts]
            h = h * s
    return h, ts


def disk_heads(base: list, cond: torch.Tensor, prec: Prec = FP32):
    """(loc (N, 2), log_scale (N, 2)) from the first 14 columns of the
    condition: PE(omega_i, 3 bands)."""
    out, _ = mlp(base, cond[:, :14], prec=prec)
    return out[:, :2], out[:, 2:4]


def sphere_heads(base: list, cond: torch.Tensor, prec: Prec = FP32):
    """(loc, log_scale, loc_von, kappa), each (N,)."""
    out, _ = mlp(base, cond[:, :14], prec=prec)
    return out[:, 0], out[:, 1], out[:, 2], torch.nn.functional.softplus(out[:, 3]) + 1e-3


def log_i0(x: torch.Tensor) -> torch.Tensor:
    """log I0 by Abramowitz & Stegun 9.8.1 and 9.8.2."""
    small_c = (1.0, 3.5156229, 3.0899424, 1.2067492, 0.2659732, 0.0360768, 0.0045813)
    large_c = (0.39894228, 0.01328592, 0.00225319, -0.00157565, 0.00916281, -0.02057706, 0.02635537,
               -0.01647633, 0.00392377)

    def poly(c, t):
        out = torch.zeros_like(t)
        for a in reversed(c):
            out = out * t + a
        return out

    x = x.abs()
    xs = torch.clamp(x, min=1e-6)
    return torch.where(x <= 3.75, torch.log(poly(small_c, (x / 3.75) ** 2)),
                       xs - 0.5 * torch.log(xs) + torch.log(poly(large_c, 3.75 / xs)))


def sphere_log_p0(heads, x: torch.Tensor) -> torch.Tensor:
    """Gaussian theta (scale exp(log_scale) + 1e-3, normalised by
    -log_scale, the density the nets were trained under) times von Mises
    phi."""
    loc, log_scale, loc_von, kappa = heads
    z = (x[:, 0] - loc) / (torch.exp(log_scale) + 1e-3)
    return (-0.5 * LOG_2PI - log_scale - 0.5 * z * z + kappa * torch.cos(x[:, 1] - loc_von) - LOG_2PI
            - log_i0(kappa))


def disk_log_p0(loc, log_scale, x: torch.Tensor) -> torch.Tensor:
    z = (x - loc) / torch.exp(log_scale)
    return -LOG_2PI - log_scale.sum(-1) - 0.5 * (z * z).sum(-1)


def cond_part(v: list, domain: str, cond: torch.Tensor, prec: Prec = FP32) -> torch.Tensor:
    """The condition's part of the velocity net's first layer: constant
    over the steps, so taken once."""
    k = (2 if domain == "disk" else 3) + 1
    return prec.mm(cond, v[0]["w"][k:])


def velocity(v: list, domain: str, x: torch.Tensor, alpha, cond: torch.Tensor, jac: bool, prec: Prec = FP32):
    """(v (N, 2), [dv/dx0, dv/dx1] or []) of the bias-free velocity net over
    [x_enc, alpha, cond]; a spherical x is encoded (theta, sin phi, cos phi).
    `cond` is the condition's first-layer part (`cond_part`)."""
    n = x.shape[0]
    a = alpha if torch.is_tensor(alpha) else torch.full((n, 1), float(alpha), device=x.device)
    one, nil = torch.ones(n, 1, device=x.device), torch.zeros(n, 1, device=x.device)
    if domain == "disk":
        h = torch.cat([x, a], dim=-1)
        tans = [torch.cat([one, nil, nil], -1), torch.cat([nil, one, nil], -1)] if jac else []
    else:
        s, c = torch.sin(x[:, 1:2]), torch.cos(x[:, 1:2])
        h = torch.cat([x[:, 0:1], s, c, a], dim=-1)
        tans = [torch.cat([one, nil, nil, nil], -1), torch.cat([nil, c, -s, nil], -1)] if jac else []
    return mlp(v, h, tans, prec, extra=cond)


def euler(v: list, domain: str, x: torch.Tensor, cond: torch.Tensor, T: int, *, reverse=False, det=False,
          prec: Prec = FP32):
    """T Euler steps (forward: alpha = t/T, x += v/T; reverse: alpha =
    1 - t/T, x -= v/T) and, with `det`, the product of det(I +- J/T)."""
    h, sign = 1.0 / T, (-1.0 if reverse else 1.0)
    d = torch.ones(x.shape[0], device=x.device)
    cond = cond_part(v, domain, cond, prec)
    for t in range(T):
        alpha = 1.0 - t * h if reverse else t * h
        vel, (j) = velocity(v, domain, x, alpha, cond, det, prec)
        if det:
            j0, j1 = j
            a_, b_ = 1.0 + sign * h * j0[:, 0], sign * h * j1[:, 0]
            c_, d_ = sign * h * j0[:, 1], 1.0 + sign * h * j1[:, 1]
            d = d * (a_ * d_ - b_ * c_)
        x = x + sign * h * vel
    return x, d


def newton_inverse(v: list, domain: str, y: torch.Tensor, cond: torch.Tensor, T: int, iters: int,
                   prec: Prec = FP32):
    """The forward Euler map inverted step by step (a reverse-Euler guess,
    then `iters` 2 x 2 Newton steps; a step det under 1e-20 in magnitude
    counts as 1) and the product of the forward dets at the recovered
    points."""
    h = 1.0 / T
    dprod = torch.ones(y.shape[0], device=y.device)
    cond = cond_part(v, domain, cond, prec)
    for t in range(T - 1, -1, -1):
        alpha = t * h
        x = y - h * velocity(v, domain, y, alpha, cond, False, prec)[0]
        for _ in range(iters):
            vx, (j0, j1) = velocity(v, domain, x, alpha, cond, True, prec)
            f = x + h * vx - y
            a_, b_, c_, d_ = 1.0 + h * j0[:, 0], h * j1[:, 0], h * j0[:, 1], 1.0 + h * j1[:, 1]
            det = a_ * d_ - b_ * c_
            det = torch.where(det.abs() > 1e-20, det, torch.ones_like(det))
            x = x - torch.stack([(d_ * f[:, 0] - b_ * f[:, 1]) / det, (-c_ * f[:, 0] + a_ * f[:, 1]) / det], -1)
        _, (j0, j1) = velocity(v, domain, x, alpha, cond, True, prec)
        dprod = dprod * ((1.0 + h * j0[:, 0]) * (1.0 + h * j1[:, 1]) - h * j1[:, 0] * h * j0[:, 1])
        y = x
    return y, dprod


# ------------------------------------------------------------------ Philox

_M = 0xFFFFFFFF


def philox(counters: list, seed: int) -> list:
    """Philox4x32-10 (Salmon et al., SC'11) of four uint32 counter arrays
    (held in uint64) under the 64-bit key `seed`."""
    k0, k1 = seed & _M, (seed >> 32) & _M
    c = [np.asarray(x, np.uint64) for x in counters]
    m32 = np.uint64(_M)
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & _M, (k1 + 0xBB67AE85) & _M
        p0, p1 = np.uint64(0xD2511F53) * c[0], np.uint64(0xCD9E8D57) * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ np.uint64(k0), p1 & m32,
             (p0 >> np.uint64(32)) ^ c[3] ^ np.uint64(k1), p0 & m32]
    return c


def _u24(w) -> np.ndarray:
    return (w >> np.uint64(8)).astype(np.float64) * 2.0 ** -24


def _normal(w1, w2) -> np.ndarray:
    u1 = np.clip(_u24(w1), 1e-7, 1.0 - 1e-7)
    return np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * math.pi * _u24(w2))


def disk_normals(seed: int, rows: np.ndarray) -> np.ndarray:
    """(n, 2) standard normals of the disk sampler's rows `rows`: one
    Philox block on counter (row lo, row hi, 0, 0), Box-Muller on words
    (0, 1) and (2, 3)."""
    rows = np.asarray(rows, np.uint64)
    z = np.zeros_like(rows)
    w = philox([rows & np.uint64(_M), rows >> np.uint64(32), z, z], seed)
    return np.stack([_normal(w[0], w[1]), _normal(w[2], w[3])], -1).astype(np.float32)


def sphere_uniforms(seed: int, rows: np.ndarray):
    """(eps (n,), u (16, 3, n)) of the spherical sampler's rows: Philox
    blocks j = 0..12 on counters (row lo, row hi, j, 0); words 0, 1 give a
    Box-Muller normal, words 2 + 3 r + k the k-th uniform of round r, in
    [1e-7, 1 - 1e-7]."""
    rows = np.asarray(rows, np.uint64)
    z = np.zeros_like(rows)
    words = []
    for j in range(13):
        words += philox([rows & np.uint64(_M), rows >> np.uint64(32), z + np.uint64(j), z], seed)
    u = np.clip(np.stack([_u24(words[2 + i]) for i in range(48)]), 1e-7, 1.0 - 1e-7).reshape(16, 3, -1)
    return _normal(words[0], words[1]).astype(np.float32), u.astype(np.float32)


def von_mises(u: torch.Tensor, loc: torch.Tensor, kappa: torch.Tensor) -> torch.Tensor:
    """Best-Fisher's wrapped-Cauchy rejection over 16 rounds of uniforms
    (16, 3, N): the first accepted round's angle (round 0's if none),
    wrapped to [-pi, pi); uniform on the circle where kappa < 1e-6."""
    k = torch.clamp(kappa, min=1e-12)
    tau = 1.0 + torch.sqrt(1.0 + 4.0 * k * k)
    rho = (tau - torch.sqrt(2.0 * tau)) / (2.0 * k)
    r = (1.0 + rho * rho) / (2.0 * rho)
    z = torch.cos(math.pi * u[:, 0])
    f = (1.0 + r * z) / (r + z)
    c = k * (r - f)
    ok = ((c * (2.0 - c) - u[:, 1]) > 0) | ((torch.log(c / u[:, 1]) + 1.0 - c) >= 0)
    ang = torch.sign(u[:, 2] - 0.5) * torch.arccos(torch.clamp(f, -1.0, 1.0))
    first = torch.argmax(ok.to(torch.uint8), dim=0)
    out = torch.gather(ang, 0, first[None])[0] + loc
    out = torch.remainder(out + math.pi, 2.0 * math.pi) - math.pi
    return torch.where(kappa < 1e-6, u[0, 0] * 2.0 * math.pi - math.pi, out)
