"""The 2D warp's users on Hopper: the envmap emitter and the measured RGL
BRDF, one launch of `csrc/warp2d.cu` a call.

Each public entry point of `render/envmap.py` (`sample_env`, `eval_env`,
`pdf_env`) and of `bsdf/measured.py` (`eval_brdf`, `pdf_brdf`,
`eval_pdf_brdf`, `eval_lum`, `sample_brdf`) sends CUDA tensors here and
CPU tensors to its plain version (`*_plain` beside it), which this module
never runs: for a CUDA tensor a wrapper launches its kernel or raises. The
kernels replace no TPU kernel (the JAX package runs the warp under XLA);
they replace the plain versions' 45 to 858 whole-wavefront PyTorch
operations a call with one launch, one thread a row, over one device
implementation of the warp (`bsdf/marginal2d.py`'s sample, invert and
eval over a blend of 1, 2 or 4 parameter slices). See the source for what
bounds them and how they round.

A wrapper allocates its outputs, launches on the current stream, does not
synchronize and reads nothing back, so it can be captured in a CUDA graph
(the MCMC sweep replays `eval_lum`). It adds one to its entry of
`launches` per launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from bsdf_diffusion_sampling_tpu_torch.ops import cuda_build

launches = {"sample_env": 0, "eval_env": 0, "pdf_env": 0, "eval_brdf": 0, "pdf_brdf": 0, "eval_pdf_brdf": 0,
            "eval_lum": 0, "sample_brdf": 0}

# `bsdf_warp2d_env`'s and `bsdf_warp2d_brdf`'s `which`
_ENV = {"sample_env": 0, "eval_env": 1, "pdf_env": 2}
_BRDF = {"eval_brdf": 0, "pdf_brdf": 1, "eval_pdf_brdf": 2, "eval_lum": 3, "sample_brdf": 4}
# `bsdf_warp2d_kernel_info`'s kernels, in its order
KERNEL_INFO = ("env sample", "env eval", "env pdf", "brdf eval_pdf 2 slices", "brdf eval_pdf 4 slices",
               "brdf sample 2 slices", "brdf sample 4 slices")


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("warp2d.cu")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.bsdf_warp2d_env.argtypes = [I, P, I, I, P, P, P, I, I, P, P, P, I, P, P, P, P]
    lib.bsdf_warp2d_env.restype = I
    lib.bsdf_warp2d_brdf.argtypes = [I, I, P, P, P, I, I, P, P, P, I, I, P, I, P, I, P, I, I, P, I, P, I, P, P, I,
                                     P, P, P]
    lib.bsdf_warp2d_brdf.restype = I
    lib.bsdf_warp2d_kernel_info.argtypes = [I, P]
    lib.bsdf_warp2d_kernel_info.restype = I
    return lib


def kernel_resources() -> dict:
    """{kernel: {registers, local_bytes, blocks_per_sm, shared_bytes}} at
    256 threads a block, on the current card."""
    out = {}
    for which, name in enumerate(KERNEL_INFO):
        buf = (ctypes.c_int * 4)()
        _raise_on(_lib().bsdf_warp2d_kernel_info(which, ctypes.cast(buf, ctypes.c_void_p)), f"kernel_info {name}")
        out[name] = dict(zip(("registers", "local_bytes", "blocks_per_sm", "shared_bytes"), buf))
    return out


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def _table(t: torch.Tensor, name: str, shape: tuple, device: torch.device) -> int:
    if t.device != device or t.dtype != torch.float32 or not t.is_contiguous() or tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected a contiguous float32 table of shape {shape} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}"
                         f"{'' if t.is_contiguous() else ' (not contiguous)'}")
    return t.data_ptr()


def _rows(x: torch.Tensor, name: str, width: int) -> torch.Tensor:
    """`x` (..., width) float32 on the card, as contiguous rows."""
    if x.dtype != torch.float32 or x.ndim < 1 or x.shape[-1] != width:
        raise ValueError(f"{name}: expected float32 rows (..., {width}), got {x.dtype} {tuple(x.shape)}")
    if x.device.type != "cuda":
        raise ValueError(f"{name}: the warp kernels run on CUDA tensors, got {x.device}")
    # the row index is an int32 up to the last block of 256 threads; the offsets into rows are size_t
    if x.numel() // width > 2 ** 31 - 256:
        raise ValueError(f"{name}: {x.numel() // width} rows exceed the kernels' int32 row index")
    return x.contiguous()


def _warp(w, name: str, slices: int, device) -> list:
    """[density, cond, marg, H, W] of a `Warp2D` of `slices` slices."""
    P, H, W = w.density.shape
    if P != slices or H < 2 or W < 2:
        raise ValueError(f"{name}: expected {slices} slices of at least 2 x 2 vertices, got {tuple(w.density.shape)}")
    return [_table(w.density, f"{name}.density", (P, H, W), device),
            _table(w.cond_cdf, f"{name}.cond_cdf", (P, H, W), device),
            _table(w.marg_cdf, f"{name}.marg_cdf", (P, H), device), H, W]


# ------------------------------------------------------------------ envmap


def _env(entry: str, env, x: torch.Tensor, width: int):
    x = _rows(x, entry, width)
    dev = x.device
    h, w, _ = env.data.shape
    args = [_table(env.data, "env.data", (h, w, 3), dev), h, w, *_warp(env.warp, "env.warp", 1, dev),
            _table(env.to_world, "env.to_world", (3, 3), dev), _table(env.to_local, "env.to_local", (3, 3), dev)]
    lead = x.shape[:-1]
    n = x.numel() // width
    d = torch.empty(lead + (3,), dtype=torch.float32, device=dev) if entry == "sample_env" else None
    rad = torch.empty(lead + (3,), dtype=torch.float32, device=dev) if entry != "pdf_env" else None
    pdf = torch.empty(lead, dtype=torch.float32, device=dev) if entry != "eval_env" else None
    if n:
        with torch.cuda.device(dev):
            rc = _lib().bsdf_warp2d_env(_ENV[entry], *args, x.data_ptr(), n,
                                        *(None if t is None else t.data_ptr() for t in (d, rad, pdf)),
                                        torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(rc, entry)
        launches[entry] += 1
    return d, rad, pdf


def sample_env(env, u2: torch.Tensor):
    """`render/envmap.py::sample_env` on the card: (d_world, radiance, pdf)."""
    return _env("sample_env", env, u2, 2)


def eval_env(env, d_world: torch.Tensor) -> torch.Tensor:
    return _env("eval_env", env, d_world, 3)[1]


def pdf_env(env, d_world: torch.Tensor) -> torch.Tensor:
    return _env("pdf_env", env, d_world, 3)[2]


# ------------------------------------------------------------ measured BRDF


def _brdf_args(brdf, dev) -> list:
    """The measured BRDF's tables as `bsdf_warp2d_brdf` takes them, from
    `nsl` on; both warps condition on the BRDF's own (phi_i, theta_i)
    grids, as `measured_from_tensors` builds them."""
    Pt = brdf.theta_i_grid.shape[0]
    aniso = brdf.phi_i_grid is not None and brdf.phi_i_grid.shape[0] > 1
    Pp = brdf.phi_i_grid.shape[0] if aniso else 1
    nsl = 4 if aniso else (1 if Pt == 1 else 2)
    rh, rw = brdf.rgb.shape[-2:]
    return [nsl, *_warp(brdf.vndf, "vndf", Pp * Pt, dev), *_warp(brdf.luminance, "luminance", Pp * Pt, dev),
            _table(brdf.theta_i_grid, "theta_i_grid", (Pt,), dev), Pt,
            _table(brdf.phi_i_grid, "phi_i_grid", (Pp,), dev) if aniso else None, Pp,
            _table(brdf.rgb, "rgb", (Pp * Pt, 3, rh, rw), dev), rh, rw,
            _table(brdf.ndf, "ndf", (2, brdf.ndf.shape[-1]), dev), brdf.ndf.shape[-1],
            _table(brdf.sigma, "sigma", (2, brdf.sigma.shape[-1]), dev), brdf.sigma.shape[-1]]


def _brdf(entry: str, brdf, a: torch.Tensor, b: torch.Tensor):
    a = _rows(a, entry, 2 if entry == "sample_brdf" else 3)
    b = _rows(b, entry, 3)
    if a.shape[:-1] != b.shape[:-1] or a.device != b.device:
        raise ValueError(f"{entry}: expected the same rows in both inputs, on one device, got {tuple(a.shape)} on "
                         f"{a.device} and {tuple(b.shape)} on {b.device}")
    dev, lead = a.device, a.shape[:-1]
    args = _brdf_args(brdf, dev)
    n = b.numel() // 3
    f = None
    if entry == "eval_lum":
        f = torch.empty(lead, dtype=torch.float32, device=dev)
    elif entry != "pdf_brdf":
        f = torch.empty(lead + (3,), dtype=torch.float32, device=dev)
    pdf = torch.empty(lead, dtype=torch.float32, device=dev) if entry in ("pdf_brdf", "eval_pdf_brdf",
                                                                            "sample_brdf") else None
    if n:
        with torch.cuda.device(dev):
            rc = _lib().bsdf_warp2d_brdf(_BRDF[entry], *args, a.data_ptr(), b.data_ptr(), n,
                                         None if f is None else f.data_ptr(), None if pdf is None else pdf.data_ptr(),
                                         torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(rc, entry)
        launches[entry] += 1
    return f, pdf


def eval_brdf(brdf, wi: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """`bsdf/measured.py::eval_brdf` on the card."""
    return _brdf("eval_brdf", brdf, wi, wo)[0]


def pdf_brdf(brdf, wi: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    return _brdf("pdf_brdf", brdf, wi, wo)[1]


def eval_pdf_brdf(brdf, wi: torch.Tensor, wo: torch.Tensor):
    return _brdf("eval_pdf_brdf", brdf, wi, wo)


def eval_lum(brdf, wi: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    return _brdf("eval_lum", brdf, wi, wo)[0]


def sample_brdf(brdf, u: torch.Tensor, wi: torch.Tensor):
    """`bsdf/measured.py::sample_brdf` on the card: (wo, pdf)."""
    return _brdf("sample_brdf", brdf, u, wi)
