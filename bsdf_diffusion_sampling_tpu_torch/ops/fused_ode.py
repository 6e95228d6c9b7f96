"""The fused ODE kernels on Hopper: disk sample+pdf (K1), disk pdf query
(K2), spherical sample+pdf (K4) and the generic transport (K3).

- K1 `fused_sample_pdf_disk` replaces the JAX package's
  `ops/fused_ode.py::_fused_sample_pdf_kernel` (pallas_call at :684): base
  heads -> x0 = loc + eps * exp(log_scale) -> T forward Euler steps of the
  velocity net -> pdf = N(x0) / det.
- K2 `fused_pdf_disk` replaces `_fused_pdf_kernel` (pallas_call at :1017)
  with its loops `_disk_ode_loop` (reverse Euler, pdf = p0 * det) and
  `_disk_pdf_exact_loop` (the Newton inverse of the forward map, pdf = p0 /
  det).
- K4 `fused_sample_pdf_spherical` replaces `_fused_sample_pdf_sph_kernel`
  (pallas_call at :1534): Gaussian theta0 x von Mises phi0 (Best-Fisher,
  16 fixed rounds), T forward steps on (theta, sin phi, cos phi), pdf = p0 /
  det.
- K3 `fused_transport_packed` replaces `_fused_ode_kernel` (pallas_call at
  :373): T Euler steps, disk or spherical, forward or reverse, with or
  without the det product.

The kernels are CUDA C++ (`csrc/fused_ode.cu`, `fused_sph.cu`,
`fused_transport.cu`), built for `sm_90a` at first use and called through
`ctypes`. What bounds them on the card: operations. Per sample K1 and the
reverse K2 do ~27k multiply-adds against ~110 bytes of I/O, the exact K2
~89k, K4 ~78k, so arithmetic is the limit, not device memory. All run the
velocity MLP on the tensor cores (`csrc/ode_mlp_tc.cuh`): a warp takes two
tiles of 16 samples, each sample three rows where the Jacobian is needed
(primal and two tangent streams) and one row where it is not (K3's primal
transports, K2's warm starts), and the hidden products run on `mma.sync`
m16n8k8 in 3xTF32 (each operand split into two TF32 parts, three
products: fp32 accuracy); the per-sample work (base heads, draw, log p0,
det) stays one lane a sample, and the exact K2's 2x2 Newton solves are
local to each lane's registers. All take the condition's part of the first
layer once per sample instead of once per step. The TPU kernels' lane
packing, roll shuffles and output compaction, and K3's `interleave` and
`tile` scheduling knobs, have no counterpart.

Det: K1, K4, K3 and reverse K2 carry the two tangent streams across the steps and
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
    EPS_SPHERICAL,
    disk_heads_from_enc,
    disk_log_prob_from_heads,
    spherical_draw,
    spherical_heads_from_enc,
    spherical_log_prob_from_heads,
)
from bsdf_diffusion_sampling_tpu_torch.models.von_mises import N_ROUNDS, U_LO
from bsdf_diffusion_sampling_tpu_torch.ode.flow import newton_inverse, transport, transport_with_det
from bsdf_diffusion_sampling_tpu_torch.ops import cuda_build

COND_DIM = 22  # PE(omega_i, 5 bands)
BASE_COLS = 14  # PE(omega_i, 3 bands): the first 14 columns of cond_enc
X_ENC = {"disk": 2, "spherical": 3}  # the velocity net's x columns
# (hidden width, hidden layers) each kernel is built for
K12_NET = (32, 3)  # disk
K4_NET = (32, 4)  # spherical
K3_NETS = {("disk", 32, 3, True), ("disk", 32, 3, False), ("spherical", 32, 4, True),
           ("spherical", 32, 4, False), ("spherical", 64, 6, False)}  # (domain, H, layers, with_jac)

launches = {"fused_sample_pdf_disk": 0, "fused_pdf_disk": 0, "fused_sample_pdf_spherical": 0,
            "fused_transport": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


class PackedWeights(NamedTuple):
    """A model's parameter trees and their flat kernel copy: velocity W0
    (x_enc + 23, H), W1.. (H, H), W_out (H, 2), then (for the sampling
    kernels) base W0 (14, 16), b0, W1 (16, 4), b1, each (in, out) row-major
    as in the JAX package. `domain` is "disk" or "spherical" (the full-sphere
    domain's nets are spherical); `base_params` is None for a velocity-only
    pack."""

    v_params: list
    base_params: dict | None
    flat: torch.Tensor
    hidden: int
    layers: int
    domain: str


def prepack_velocity(v_params: list) -> PackedWeights:
    """The velocity net alone, for K3; the domain follows from its input
    width (25 disk, 26 spherical). The kernels have no bias term, so a
    layer with a `"b"` raises, where the plain versions would add it."""
    d_in = v_params[0]["w"].shape[0] - 1 - COND_DIM
    domain = {2: "disk", 3: "spherical"}.get(d_in)
    if domain is None or v_params[-1]["w"].shape[1] != 2:
        raise ValueError("expected a velocity net over [x_enc(2 or 3), alpha, cond_enc(22)] -> 2")
    biased = [i for i, layer in enumerate(v_params) if "b" in layer]
    if biased:
        raise ValueError(f"the kernels' velocity nets are bias-free; layers {biased} carry a bias")
    flat = torch.cat([layer["w"].reshape(-1) for layer in v_params]).to(torch.float32).contiguous()
    return PackedWeights(v_params, None, flat, v_params[0]["w"].shape[1], len(v_params) - 1, domain)


def _prepack(v_params: list, base_params: dict, domain: str) -> PackedWeights:
    vel = prepack_velocity(v_params)
    if vel.domain != domain:
        raise ValueError(f"expected a {domain} velocity net, got a {vel.domain} one")
    net = base_params["net"]
    if net[0]["w"].shape[0] != BASE_COLS or net[1]["w"].shape[1] != 4:
        raise ValueError("expected base heads over PE(omega_i, 3 bands) -> 4")
    base = torch.cat([t.reshape(-1) for t in (net[0]["w"], net[0]["b"], net[1]["w"], net[1]["b"])])
    flat = torch.cat([vel.flat, base.to(torch.float32)]).contiguous()
    return vel._replace(base_params=base_params, flat=flat)


def prepack_disk(v_params: list, base_params: dict) -> PackedWeights:
    return _prepack(v_params, base_params, "disk")


def prepack_spherical(v_params: list, base_params: dict) -> PackedWeights:
    return _prepack(v_params, base_params, "spherical")


# ------------------------------------------------------------ plain versions


_M32 = 0xFFFFFFFF


def _philox4x32_10(c0: np.ndarray, c1: np.ndarray, k0: int, k1: int, c2: int = 0, c3: int = 0) -> list:
    """Philox4x32-10 (Salmon et al., SC'11) on counters (c0, c1, c2, c3),
    uint32 values held in uint64 arrays, under the key (k0, k1)."""
    m32 = np.uint64(_M32)
    c = [c0, c1, np.full_like(c0, c2), np.full_like(c0, c3)]
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
    eps = [_box_muller(words[2 * k], words[2 * k + 1]) for k in range(2)]
    return torch.from_numpy(np.stack(eps, axis=-1).astype(np.float32))


def _unit24(w: np.ndarray) -> np.ndarray:
    """Top 24 bits of each word -> float32 in [0, 1)."""
    return (w >> np.uint64(8)).astype(np.float32) * np.float32(2.0**-24)


def _clip_u(w: np.ndarray) -> np.ndarray:
    return np.clip(_unit24(w), np.float32(U_LO), np.float32(1.0) - np.float32(U_LO))


def _box_muller(w1: np.ndarray, w2: np.ndarray) -> np.ndarray:
    two_pi = np.float32(2.0 * math.pi)
    return np.sqrt(np.float32(-2.0) * np.log(_clip_u(w1))) * np.cos(two_pi * _unit24(w2))


SPH_WORDS = 2 + 3 * N_ROUNDS  # a Box-Muller pair, then 16 Best-Fisher rounds of 3 uniforms
SPH_BLOCKS = (SPH_WORDS + 3) // 4  # Philox blocks a sample


def philox_spherical_draws(seed: int, n: int):
    """(eps_g (n,), u_von (16, 3, n)) exactly as K4 draws them in-kernel:
    Philox4x32-10 keyed by the 64-bit seed on counters (i, 0, j, 0), j =
    0..12, for sample i; words 0, 1 feed Box-Muller for eps_g, words 2 + 3r
    + role the uniforms of Best-Fisher round r, clipped to [1e-7, 1 - 1e-7]."""
    seed &= (1 << 64) - 1
    idx = np.arange(n, dtype=np.uint64)
    words = []
    for j in range(SPH_BLOCKS):
        words += _philox4x32_10(idx & np.uint64(_M32), idx >> np.uint64(32), seed & _M32, seed >> 32, c2=j)
    eps_g = _box_muller(words[0], words[1])
    u = np.stack([_clip_u(words[2 + k]) for k in range(3 * N_ROUNDS)]).reshape(N_ROUNDS, 3, n)
    return torch.from_numpy(eps_g.astype(np.float32)), torch.from_numpy(u)


def sample_pdf_disk_plain(w: PackedWeights, cond_enc: torch.Tensor, T: int, *,
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


def pdf_disk_plain(w: PackedWeights, x: torch.Tensor, cond_enc: torch.Tensor, T: int, *,
                   exact: bool = True, newton_iters: int = 2):
    """K2's function in plain PyTorch: (pdf, x0) of query points x (N, 2)."""
    if exact:
        x0, det = newton_inverse("disk", w.v_params, x, cond_enc, T, newton_iters)
    else:
        x0, det = transport_with_det("disk", w.v_params, x, cond_enc, T, reverse=True)
    loc, log_scale = disk_heads_from_enc(w.base_params, cond_enc[..., :BASE_COLS])
    p0 = torch.exp(disk_log_prob_from_heads(loc, log_scale, x0))
    return (p0 / det if exact else p0 * det), x0


def sample_pdf_spherical_plain(w: PackedWeights, cond_enc: torch.Tensor, T: int, *,
                               eps: torch.Tensor | None = None, x0: torch.Tensor | None = None):
    """K4's function in plain PyTorch: (x, pdf, x0) from `eps` (N, 2) =
    (standard normal for theta, von Mises phi already drawn), or from a
    given `x0` (which checks a kernel's transport at its own draw)."""
    if (eps is None) == (x0 is None):
        raise ValueError("pass exactly one of eps and x0")
    heads = spherical_heads_from_enc(w.base_params, cond_enc[..., :BASE_COLS])
    if x0 is None:
        loc, log_scale = heads[0], heads[1]
        x0 = torch.stack([loc + eps[..., 0] * (torch.exp(log_scale) + EPS_SPHERICAL), eps[..., 1]], dim=-1)
    p0 = torch.exp(spherical_log_prob_from_heads(heads, x0))
    x, det = transport_with_det("spherical", w.v_params, x0, cond_enc, T)
    return x, p0 / det, x0


def spherical_x0_from_seed(w: PackedWeights, cond_enc: torch.Tensor, seed: int) -> torch.Tensor:
    """The x0 = (theta0, phi0) K4 draws in-kernel from `seed`, in plain
    PyTorch on cond_enc's device (the uniforms from `philox_spherical_draws`)."""
    eps_g, u = philox_spherical_draws(int(seed), cond_enc.shape[0])
    heads = spherical_heads_from_enc(w.base_params, cond_enc[..., :BASE_COLS])
    return spherical_draw(heads, eps_g.to(cond_enc.device), u.to(cond_enc.device))


def transport_plain(domain: str, w: PackedWeights, x: torch.Tensor, cond_enc: torch.Tensor, T: int, *,
                    reverse: bool = False, with_jac: bool = True):
    """K3's function in plain PyTorch: (x_out, det product); det is 0
    without `with_jac`, as the kernel leaves it."""
    if with_jac:
        return transport_with_det(domain, w.v_params, x, cond_enc, T, reverse=reverse)
    return transport(domain, w.v_params, x, cond_enc, T, reverse=reverse), x.new_zeros(x.shape[:-1])


# ------------------------------------------------------------------ wrappers


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("fused_ode.cu")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.bsdf_fused_sample_pdf_disk.argtypes = [P, P, P, P, P, P, P, I, I, I, I, P]
    lib.bsdf_fused_sample_pdf_disk.restype = I
    lib.bsdf_fused_pdf_disk.argtypes = [P, P, P, P, P, I, I, I, I, I, I, P]
    lib.bsdf_fused_pdf_disk.restype = I
    lib.bsdf_fused_ode_kernel_info.argtypes = [I, P]
    lib.bsdf_fused_ode_kernel_info.restype = I
    return lib


@functools.lru_cache(maxsize=None)
def _lib_sph() -> ctypes.CDLL:
    lib = cuda_build.load("fused_sph.cu")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.bsdf_fused_sample_pdf_spherical.argtypes = [P, P, P, P, P, P, P, I, I, I, I, P]
    lib.bsdf_fused_sample_pdf_spherical.restype = I
    lib.bsdf_fused_sph_kernel_info.argtypes = [I, P]
    lib.bsdf_fused_sph_kernel_info.restype = I
    return lib


@functools.lru_cache(maxsize=None)
def _lib_transport() -> ctypes.CDLL:
    lib = cuda_build.load("fused_transport.cu")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.bsdf_fused_transport.argtypes = [P, P, P, P, P, I, I, I, I, I, I, I, P]
    lib.bsdf_fused_transport.restype = I
    lib.bsdf_fused_transport_kernel_info.argtypes = [I, P]
    lib.bsdf_fused_transport_kernel_info.restype = I
    return lib


# K3's instantiations in the order of `bsdf_fused_transport_kernel_info`
K3_INFO = ("K3 disk 3x32 det", "K3 disk 3x32 primal", "K3 spherical 4x32 det", "K3 spherical 4x32 primal",
           "K3 spherical 6x64 primal")


def kernel_resources() -> dict:
    """{instantiation: {registers, local_bytes, blocks_per_sm, shared_bytes}}
    of K1 and K4 (each with the eps and the Philox draw), K2 (exact and
    reverse) and K3's five nets, at their block sizes (128 threads; 256 for K3's 64 x 6 net), from
    `cudaFuncGetAttributes` and `cudaOccupancyMaxActiveBlocksPerMultiprocessor`
    on the current card."""
    out = {}
    for lib, fn, names in ((_lib(), "bsdf_fused_ode_kernel_info", ("K1 eps", "K1 philox", "K2 exact", "K2 reverse")),
                           (_lib_sph(), "bsdf_fused_sph_kernel_info", ("K4 eps", "K4 philox")),
                           (_lib_transport(), "bsdf_fused_transport_kernel_info", K3_INFO)):
        for which, name in enumerate(names):
            buf = (ctypes.c_int * 4)()
            _raise_on(getattr(lib, fn)(which, ctypes.cast(buf, ctypes.c_void_p)), f"{fn}({which})")
            out[name] = dict(zip(("registers", "local_bytes", "blocks_per_sm", "shared_bytes"), buf))
    return out


def _check(t: torch.Tensor, name: str, shape: tuple, device: torch.device) -> None:
    if t.device != device or t.dtype != torch.float32 or not t.is_contiguous() or tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected a contiguous float32 tensor of shape {shape} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}"
                         f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def _check_launch(w: PackedWeights, cond_enc: torch.Tensor, T: int, net: tuple = K12_NET,
                  domain: str = "disk") -> torch.device:
    dev = cond_enc.device
    if dev.type != "cuda":
        raise ValueError(f"the fused kernels run on CUDA tensors, got {dev}")
    if w.domain != domain or (w.hidden, w.layers) != net:
        raise ValueError(f"this kernel is built for a {domain} net of {net[1]} hidden layers of width {net[0]}, "
                         f"got a {w.domain} net of {w.layers} of width {w.hidden}")
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


def fused_sample_pdf_disk(w: PackedWeights, cond_enc: torch.Tensor, T: int, *,
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


def fused_pdf_disk(w: PackedWeights, x: torch.Tensor, cond_enc: torch.Tensor, T: int, *,
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


def fused_sample_pdf_spherical(w: PackedWeights, cond_enc: torch.Tensor, T: int, *,
                               eps: torch.Tensor | None = None, seed=None):
    """Spherical sample+pdf, (x, pdf, x0) for cond_enc (N, 22). Pass `eps`
    (N, 2) = (standard normal for theta, von Mises phi), or a `seed` (an int
    or a one-element int64 tensor) for the in-kernel draw that
    `philox_spherical_draws` reproduces."""
    if (eps is None) == (seed is None):
        raise ValueError("pass exactly one of eps and seed")
    n = cond_enc.shape[0]
    if cond_enc.device.type == "cpu":
        if eps is None:
            return sample_pdf_spherical_plain(w, cond_enc, T, x0=spherical_x0_from_seed(w, cond_enc, int(seed)))
        return sample_pdf_spherical_plain(w, cond_enc, T, eps=eps)
    dev = _check_launch(w, cond_enc, T, K4_NET, "spherical")
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
        rc = _lib_sph().bsdf_fused_sample_pdf_spherical(
            cond_enc.data_ptr(), eps_ptr, None if seed_t is None else seed_t.data_ptr(),
            w.flat.data_ptr(), x.data_ptr(), pdf.data_ptr(), x0.data_ptr(), n, T,
            w.hidden, w.layers, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "fused_sample_pdf_spherical")
    launches["fused_sample_pdf_spherical"] += 1
    return x, pdf, x0


def fused_transport_packed(w: PackedWeights, domain: str, x0: torch.Tensor, cond_enc: torch.Tensor, T: int,
                           reverse: bool = False, with_jac: bool = True):
    """T-step Euler transport of x0 (N, 2) with prepacked weights (any pack
    of `prepack_velocity`, `prepack_disk` or `prepack_spherical`; the kernel
    reads the velocity part). Forward: (x_T, prod_t det(I + J_t/T));
    reverse: (x_0, prod_t det(I - J_t/T)); without `with_jac` the det is 0.
    The full-sphere domain transports as the spherical one."""
    domain = "disk" if domain == "disk" else "spherical"
    n = cond_enc.shape[0]
    if cond_enc.device.type == "cpu":
        return transport_plain(domain, w, x0, cond_enc, T, reverse=reverse, with_jac=with_jac)
    if (domain, w.hidden, w.layers, bool(with_jac)) not in K3_NETS:
        raise ValueError(f"the transport kernel is not built for a {domain} net of {w.layers} hidden layers of "
                         f"width {w.hidden}{' with the det' if with_jac else ''}; built: {sorted(K3_NETS)}")
    dev = _check_launch(w, cond_enc, T, (w.hidden, w.layers), domain)
    _check(x0, "x0", (n, 2), dev)
    x = torch.empty((n, 2), dtype=torch.float32, device=dev)
    det = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0:
        return x, det
    with torch.cuda.device(dev):
        rc = _lib_transport().bsdf_fused_transport(
            x0.data_ptr(), cond_enc.data_ptr(), w.flat.data_ptr(), x.data_ptr(), det.data_ptr(), n, T,
            X_ENC[domain], int(reverse), int(with_jac), w.hidden, w.layers,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "fused_transport")
    launches["fused_transport"] += 1
    return x, det


def fused_ode_transport(domain: str, v_params: list, x0: torch.Tensor, cond_enc: torch.Tensor, T: int,
                        reverse: bool = False, with_jac: bool = True):
    """`fused_transport_packed` from the velocity net's parameter tree."""
    return fused_transport_packed(prepack_velocity(v_params), domain, x0, cond_enc, T, reverse=reverse,
                                  with_jac=with_jac)


# ------------------------------------------------------------ differentiable


class _TransportDiff(torch.autograd.Function):
    """K3 with the det in the forward; the backward rematerialises the T
    steps through the plain `transport_with_det` and takes its vector-Jacobian
    product (reverse over the forward-mode Jacobian columns). Only the inputs
    are saved: no per-step activation outlives the forward."""

    @staticmethod
    def forward(ctx, domain, T, reverse, x0, cond_enc, *weights):
        ctx.domain, ctx.T, ctx.reverse = domain, T, reverse
        ctx.save_for_backward(x0, cond_enc, *weights)
        w = prepack_velocity([{"w": t} for t in weights])
        return fused_transport_packed(w, domain, x0, cond_enc, T, reverse=reverse, with_jac=True)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_x, g_det):
        saved = ctx.saved_tensors
        wanted = [i for i in range(len(saved)) if ctx.needs_input_grad[3 + i]]
        grads = [None] * len(saved)
        if wanted:
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(i in wanted) for i, t in enumerate(saved)]
                x0, cond_enc, *weights = leaves
                x, det = transport_with_det(ctx.domain, [{"w": t} for t in weights], x0, cond_enc, ctx.T,
                                            reverse=ctx.reverse)
                found = torch.autograd.grad((x, det), [leaves[i] for i in wanted], (g_x, g_det))
            for i, g in zip(wanted, found):
                grads[i] = g
        return (None, None, None, *grads)


def fused_transport_diff(domain: str, v_params: list, x0: torch.Tensor, cond_enc: torch.Tensor, T: int,
                         reverse: bool = False):
    """Differentiable K3 transport, (x_out, det_prod) as `fused_ode_transport`
    with the det gives them; gradients flow to every weight of `v_params`,
    to `x0` and to `cond_enc` (counterpart of the JAX package's
    `ops/fused_ode.py::fused_transport_diff`, whose backward is the XLA VJP of
    `_xla_transport_with_det`). Nets: those K3 is built for with the det,
    disk 3 x 32 and spherical 4 x 32; the 6 x 64 teacher raises."""
    kdom = "disk" if domain == "disk" else "spherical"
    w = prepack_velocity(v_params)
    if (kdom, w.hidden, w.layers, True) not in K3_NETS:
        raise ValueError(f"the transport kernel has no det instantiation for a {kdom} net of {w.layers} hidden "
                         f"layers of width {w.hidden}; built: {sorted(K3_NETS)}")
    return _TransportDiff.apply(kdom, T, reverse, x0, cond_enc, *(layer["w"] for layer in v_params))
