"""The plain reference of a rectify iteration (full-sphere domain): the
iteration's omega_i, base draws and alphas drawn again from the iteration's
torch generator in the order the stage draws them, the teacher's T-step
Euler transport of the base draws, the flow-matching loss on the shortest
arc in phi, its gradient by autograd and an Adam step at optax's defaults.
"""

from __future__ import annotations

import hashlib
import math

import torch

from .flow import FP32, Prec, euler, mlp, pe, sphere_heads, von_mises


def fold_in(seed: int, data) -> int:
    """The child seed of `seed` for `data`: a keyed blake2b hash, the
    derivation the training stages seed their generators by."""
    msg = f"{int(seed)}/{type(data).__name__}:{data}".encode()
    return int.from_bytes(hashlib.blake2b(msg, digest_size=8).digest(), "little") & ((1 << 63) - 1)


def draw_batch(stage_seed: int, it: int, base: list, teacher: list, n_wi: int, n_per_wi: int, T: int,
               device, prec: Prec = FP32, block: int = 1 << 20) -> dict:
    """Iteration `it`'s pairs: n_wi stratified (theta in [0, pi), phi in
    [-pi, pi)), each repeated n_per_wi times; x0 from the base density
    (theta Gaussian, phi von Mises); x1 the teacher's transport; alpha a
    permutation of the linspace over the pairs."""
    gen = torch.Generator(device=device).manual_seed(fold_in(stage_seed, int(it)))
    side = math.isqrt(n_wi)
    side += side * side < n_wi
    cell = torch.randperm(side * side, generator=gen, device=device)[:n_wi]
    uv = torch.stack([cell // side, cell % side], -1).float() / side
    uv = uv + torch.rand((n_wi, 2), generator=gen, device=device) / side
    wi = torch.stack([uv[:, 0] * math.pi, uv[:, 1] * 2 * math.pi - math.pi], -1)
    omega = wi.repeat_interleave(n_per_wi, dim=0)
    m = omega.shape[0]
    heads = sphere_heads(base, pe(omega, 3), prec)
    eps = torch.randn((m,), generator=gen, device=device)
    u = torch.rand((16, 3, m), generator=gen, device=device) * (1.0 - 2e-7) + 1e-7
    x0 = torch.stack([heads[0] + eps * (torch.exp(heads[1]) + 1e-3), von_mises(u, heads[2], heads[3])], -1)
    del u, eps, heads
    x1 = torch.empty_like(x0)
    with torch.no_grad():
        for a in range(0, m, block):
            x1[a:a + block] = euler(teacher, "spherical", x0[a:a + block], pe(omega[a:a + block], 5), T, prec=prec)[0]
    perm = torch.randperm(m, generator=gen, device=device)
    alpha = (perm.float() / max(m - 1, 1)).reshape(-1, 1)
    return {"omega": omega, "x0": x0, "x1": x1, "alpha": alpha}


def loss_fn(v: list, b: dict, prec: Prec = FP32, block: int = 1 << 20):
    """Mean over the pairs of |v(x_alpha, alpha, omega) - (x1' - x0)|^2 / 2
    per component, x1' with phi moved to the shortest arc from x0's; the
    sum is taken in blocks, each block's part backpropagated at once so
    that the activations of one block only are held."""
    x0, x1, alpha, omega = b["x0"], b["x1"], b["alpha"], b["omega"]
    m = x0.shape[0]
    total = 0.0
    for a in range(0, m, block):
        s = slice(a, a + block)
        d = torch.remainder(x1[s, 1] - x0[s, 1] + math.pi, 2 * math.pi) - math.pi
        y = torch.stack([x1[s, 0], x0[s, 1] + d], -1)
        al = alpha[s]
        xa = (1 - al) * x0[s] + al * y
        h = torch.cat([xa[:, 0:1], torch.sin(xa[:, 1:2]), torch.cos(xa[:, 1:2]), al, pe(omega[s], 5)], -1)
        pred, _ = mlp(v, h, prec=prec)  # one product over the whole input: what autograd differentiates
        part = ((pred - (y - x0[s])) ** 2).sum() / (2 * m)
        if any(p.requires_grad for layer in v for p in layer.values()):
            part.backward()
        total += float(part.detach())
    return total


class Adam:
    """optax.adam's defaults: betas 0.9 / 0.999, eps 1e-8 outside the
    square root, bias-corrected."""

    def __init__(self, leaves: list, lr: float):
        self.leaves, self.lr, self.t = leaves, lr, 0
        self.m = [torch.zeros_like(p) for p in leaves]
        self.v = [torch.zeros_like(p) for p in leaves]

    @torch.no_grad()
    def step(self):
        self.t += 1
        for p, m, v in zip(self.leaves, self.m, self.v):
            g = p.grad
            m.mul_(0.9).add_(g, alpha=0.1)
            v.mul_(0.999).addcmul_(g, g, value=0.001)
            p -= self.lr * (m / (1 - 0.9 ** self.t)) / (torch.sqrt(v / (1 - 0.999 ** self.t)) + 1e-8)
            p.grad = None
