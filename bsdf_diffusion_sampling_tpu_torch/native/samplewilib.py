"""ctypes wrapper for the native inverse-CDF sampler (`csrc/samplewi.cpp`,
the JAX package's `native/samplewi.cpp` with its header comment rewritten),
counterpart of the JAX package's `native/samplewilib.py`: the host twin of
`data/tabulated.py`. The library is built with `g++` at first use, into the
build directory of `ops/cuda_build.py`."""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from bsdf_diffusion_sampling_tpu_torch.ops import cuda_build


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("samplewi.cpp")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.samplewi.argtypes = [f32p, ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_uint64, f32p]
    lib.samplewi.restype = ctypes.c_int
    return lib


def samplewi_native(pdf: np.ndarray, n_samples: int, seed: int = 0) -> np.ndarray:
    """pdf: (B, res*res) or (B, res, res) non-negative grids. Returns
    (B, n_samples, 2) float32 samples in [-1, 1]^2, row b drawn from the
    stream seeded with seed + b * 0x9E3779B97F4A7C15. Raises ValueError on
    a row that sums to zero (code -2) or on any other failure (code -1: a
    size that is not positive)."""
    pdf = np.ascontiguousarray(pdf, np.float32)
    if pdf.ndim == 3:
        b, r, r2 = pdf.shape
        if r != r2:
            raise ValueError(f"not a square grid: {pdf.shape}")
        pdf = pdf.reshape(b, r * r)
    else:
        b, g = pdf.shape
        r = int(round(g ** 0.5))
        if r * r != g:
            raise ValueError(f"not a square grid: {g}")
    out = np.empty((b, n_samples, 2), np.float32)
    rc = _lib().samplewi(pdf, b, r, n_samples, seed, out.reshape(b, -1))
    if rc == -2:
        raise ValueError("samplewi: a pdf row sums to zero")
    if rc != 0:
        raise ValueError(f"samplewi failed with code {rc}")
    return out
