"""Fused disk-domain sample+pdf (K1) and pdf query (K2) on Hopper.

K1 `fused_sample_pdf_disk` replaces the JAX package's
`ops/fused_ode.py::_fused_sample_pdf_kernel` (pallas_call at :684): base
heads -> x0 = loc + eps * exp(log_scale) -> T forward Euler steps of the
velocity net -> pdf = N(x0) / det. K2 `fused_pdf_disk` replaces
`_fused_pdf_kernel` (pallas_call at :1017) with its loops `_disk_ode_loop`
(reverse Euler, pdf = p0 * det) and `_disk_pdf_exact_loop` (the Newton
inverse of the forward map, pdf = p0 / det).

Both kernels are CUDA C++ (`csrc/fused_ode.cu`), built for `sm_90a` at
first use and called through `ctypes`. What bounds them on the card:
operations. Per sample K1 does ~27k fp32 multiply-adds against ~110 bytes
of I/O, K2 exact ~89k, so FMA throughput on the CUDA cores is the limit, not
device memory. The design: one thread per sample; the velocity and base
weights (3,220 floats) staged in shared memory once per block and read as
warp-wide broadcasts; the condition's part of the first layer computed
once per sample instead of once per step; state and both tangent streams
in registers. No tensor cores yet.

Det: K1 and reverse K2 carry the two tangent streams across the steps and
take one 2x2 det at the end; exact K2 multiplies the forward step dets at
the Newton points. The plain versions multiply per-step dets
(`ode/flow.py`). Det is multiplicative, so these are the same function.

Every wrapper takes its plain version for CPU tensors only. For a CUDA
tensor it launches its kernel or raises, and adds one to its entry of
`launches` per launch.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from bsdf_diffusion_sampling_tpu_torch.models.base_density import (
    disk_heads_from_enc,
    disk_log_prob_from_heads,
)
from bsdf_diffusion_sampling_tpu_torch.ode.flow import newton_inverse, transport_with_det
from bsdf_diffusion_sampling_tpu_torch.ops import cuda_build

COND_DIM = 22  # PE(omega_i, 5 bands)
BASE_COLS = 14  # PE(omega_i, 3 bands): the first 14 columns of cond_enc
KERNEL_HIDDEN = 32  # the only velocity width the kernels are built for
KERNEL_LAYERS = 3  # hidden layers of the disk velocity net

launches = {"fused_sample_pdf_disk": 0, "fused_pdf_disk": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


class DiskWeights(NamedTuple):
    """The disk model's parameter trees and their flat kernel copy:
    velocity W0 (25, H), W1.. (H, H), W_out (H, 2), then base W0 (14, 16),
    b0, W1 (16, 4), b1, each (in, out) row-major as in the JAX package."""

    v_params: list
    base_params: dict
    flat: torch.Tensor
    hidden: int
    layers: int


def prepack_disk(v_params: list, base_params: dict) -> DiskWeights:
    hidden = v_params[0]["w"].shape[1]
    if v_params[0]["w"].shape[0] != 3 + COND_DIM or v_params[-1]["w"].shape[1] != 2:
        raise ValueError("expected a disk velocity net over [x(2), alpha, cond_enc(22)] -> 2")
    net = base_params["net"]
    if net[0]["w"].shape[0] != BASE_COLS or net[1]["w"].shape[1] != 4:
        raise ValueError("expected base heads over PE(omega_i, 3 bands) -> 4")
    leaves = [layer["w"] for layer in v_params]
    leaves += [net[0]["w"], net[0]["b"], net[1]["w"], net[1]["b"]]
    flat = torch.cat([t.reshape(-1) for t in leaves]).to(torch.float32).contiguous()
    return DiskWeights(v_params, base_params, flat, hidden, len(v_params) - 1)


# ------------------------------------------------------------ plain versions


_M32 = 0xFFFFFFFF


def _philox4x32_10(c0: np.ndarray, c1: np.ndarray, k0: int, k1: int) -> list:
    """Philox4x32-10 (Salmon et al., SC'11) on counters (c0, c1, 0, 0),
    uint32 values held in uint64 arrays, under the key (k0, k1)."""
    m32 = np.uint64(_M32)
    c = [c0, c1, np.zeros_like(c0), np.zeros_like(c0)]
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & _M32, (k1 + 0xBB67AE85) & _M32
        p0 = np.uint64(0xD2511F53) * c[0]  # < 2^64: exact
        p1 = np.uint64(0xCD9E8D57) * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ np.uint64(k0), p1 & m32,
             (p0 >> np.uint64(32)) ^ c[3] ^ np.uint64(k1), p0 & m32]
    return c


def philox_normals(seed: int, n: int) -> torch.Tensor:
    """(n, 2) float32 standard normals exactly as K1 draws them in-kernel:
    Philox4x32-10 keyed by the 64-bit seed on counter (i, 0) for sample i,
    then Box-Muller on the top 24 bits of each word pair, u1 clipped to
    [1e-7, 1 - 1e-7] (the TPU kernel's `fused_ode.py:612-621`)."""
    seed &= (1 << 64) - 1
    idx = np.arange(n, dtype=np.uint64)
    words = _philox4x32_10(idx & np.uint64(_M32), idx >> np.uint64(32), seed & _M32, seed >> 32)
    u = [(w >> np.uint64(8)).astype(np.float32) * np.float32(2.0**-24) for w in words]
    lo, hi = np.float32(1e-7), np.float32(1.0) - np.float32(1e-7)
    two_pi = np.float32(2.0 * math.pi)
    eps = [np.sqrt(np.float32(-2.0) * np.log(np.clip(u[2 * k], lo, hi))) * np.cos(two_pi * u[2 * k + 1])
           for k in range(2)]
    return torch.from_numpy(np.stack(eps, axis=-1).astype(np.float32))


def sample_pdf_disk_plain(w: DiskWeights, cond_enc: torch.Tensor, T: int, *,
                          eps: torch.Tensor | None = None, x0: torch.Tensor | None = None):
    """K1's function in plain PyTorch: (x, pdf, x0) from `eps` (N, 2), or
    from a given `x0` (which checks a kernel's transport at its own draw)."""
    if (eps is None) == (x0 is None):
        raise ValueError("pass exactly one of eps and x0")
    loc, log_scale = disk_heads_from_enc(w.base_params, cond_enc[..., :BASE_COLS])
    if x0 is None:
        x0 = loc + eps * torch.exp(log_scale)
    p0 = torch.exp(disk_log_prob_from_heads(loc, log_scale, x0))
    x, det = transport_with_det("disk", w.v_params, x0, cond_enc, T)
    return x, p0 / det, x0


def pdf_disk_plain(w: DiskWeights, x: torch.Tensor, cond_enc: torch.Tensor, T: int, *,
                   exact: bool = True, newton_iters: int = 2):
    """K2's function in plain PyTorch: (pdf, x0) of query points x (N, 2)."""
    if exact:
        x0, det = newton_inverse("disk", w.v_params, x, cond_enc, T, newton_iters)
    else:
        x0, det = transport_with_det("disk", w.v_params, x, cond_enc, T, reverse=True)
    loc, log_scale = disk_heads_from_enc(w.base_params, cond_enc[..., :BASE_COLS])
    p0 = torch.exp(disk_log_prob_from_heads(loc, log_scale, x0))
    return (p0 / det if exact else p0 * det), x0


# ------------------------------------------------------------------ wrappers


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("fused_ode.cu")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.bsdf_fused_sample_pdf_disk.argtypes = [P, P, P, P, P, P, P, I, I, I, I, P]
    lib.bsdf_fused_sample_pdf_disk.restype = I
    lib.bsdf_fused_pdf_disk.argtypes = [P, P, P, P, P, I, I, I, I, I, I, P]
    lib.bsdf_fused_pdf_disk.restype = I
    return lib


def _check(t: torch.Tensor, name: str, shape: tuple, device: torch.device) -> None:
    if t.device != device or t.dtype != torch.float32 or not t.is_contiguous() or tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected a contiguous float32 tensor of shape {shape} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}"
                         f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def _check_launch(w: DiskWeights, cond_enc: torch.Tensor, T: int) -> torch.device:
    dev = cond_enc.device
    if dev.type != "cuda":
        raise ValueError(f"the fused kernels run on CUDA tensors, got {dev}")
    if (w.hidden, w.layers) != (KERNEL_HIDDEN, KERNEL_LAYERS):
        raise ValueError(f"the fused disk kernels are built for {KERNEL_LAYERS} hidden layers of width "
                         f"{KERNEL_HIDDEN}, got {w.layers} of width {w.hidden}")
    if T < 1:
        raise ValueError(f"T must be >= 1, got {T}")
    _check(cond_enc, "cond_enc", (cond_enc.shape[0], COND_DIM), dev)
    _check(w.flat, "weights", tuple(w.flat.shape), dev)
    return dev


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def _seed_tensor(seed, device) -> torch.Tensor:
    if torch.is_tensor(seed):
        return seed.reshape(1).to(device=device, dtype=torch.int64)
    s = int(seed) & ((1 << 64) - 1)  # the kernel reads the 64 bits unsigned
    return torch.tensor([s - (1 << 64) if s >= 1 << 63 else s], dtype=torch.int64, device=device)


def fused_sample_pdf_disk(w: DiskWeights, cond_enc: torch.Tensor, T: int, *,
                          eps: torch.Tensor | None = None, seed=None):
    """Disk sample+pdf, (x, pdf, x0) for cond_enc (N, 22). Pass `eps`
    (N, 2) standard normals, or a `seed` (an int or a one-element int64
    tensor) for the in-kernel Philox draw of `philox_normals`."""
    if (eps is None) == (seed is None):
        raise ValueError("pass exactly one of eps and seed")
    n = cond_enc.shape[0]
    if cond_enc.device.type == "cpu":
        if eps is None:
            eps = philox_normals(int(seed), n)
        return sample_pdf_disk_plain(w, cond_enc, T, eps=eps)
    dev = _check_launch(w, cond_enc, T)
    x = torch.empty((n, 2), dtype=torch.float32, device=dev)
    pdf = torch.empty((n,), dtype=torch.float32, device=dev)
    x0 = torch.empty((n, 2), dtype=torch.float32, device=dev)
    if n == 0:
        return x, pdf, x0
    if eps is not None:
        _check(eps, "eps", (n, 2), dev)
        eps_ptr, seed_t = eps.data_ptr(), None
    else:
        eps_ptr, seed_t = None, _seed_tensor(seed, dev)
    with torch.cuda.device(dev):
        rc = _lib().bsdf_fused_sample_pdf_disk(
            cond_enc.data_ptr(), eps_ptr, None if seed_t is None else seed_t.data_ptr(),
            w.flat.data_ptr(), x.data_ptr(), pdf.data_ptr(), x0.data_ptr(), n, T,
            w.hidden, w.layers, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "fused_sample_pdf_disk")
    launches["fused_sample_pdf_disk"] += 1
    return x, pdf, x0


def fused_pdf_disk(w: DiskWeights, x: torch.Tensor, cond_enc: torch.Tensor, T: int, *,
                   exact: bool = True, newton_iters: int = 2):
    """Disk pdf query, (pdf, x0) for query points x (N, 2). `exact` inverts
    the forward Euler map by Newton (the production default); otherwise
    reverse Euler."""
    n = cond_enc.shape[0]
    if cond_enc.device.type == "cpu":
        return pdf_disk_plain(w, x, cond_enc, T, exact=exact, newton_iters=newton_iters)
    dev = _check_launch(w, cond_enc, T)
    _check(x, "x", (n, 2), dev)
    if newton_iters < 0:
        raise ValueError(f"newton_iters must be >= 0, got {newton_iters}")
    pdf = torch.empty((n,), dtype=torch.float32, device=dev)
    x0 = torch.empty((n, 2), dtype=torch.float32, device=dev)
    if n == 0:
        return pdf, x0
    with torch.cuda.device(dev):
        rc = _lib().bsdf_fused_pdf_disk(
            x.data_ptr(), cond_enc.data_ptr(), w.flat.data_ptr(), pdf.data_ptr(), x0.data_ptr(),
            n, T, int(exact), newton_iters, w.hidden, w.layers,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "fused_pdf_disk")
    launches["fused_pdf_disk"] += 1
    return pdf, x0
