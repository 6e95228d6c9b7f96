"""ctypes wrapper for the native binned-SAH BVH builder (`csrc/bvh_build.cpp`,
a copy of the JAX package's `native/bvh_build.cpp`), counterpart of the JAX
package's `native/bvhlib.py`. The library is built with `g++` at first use."""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np

from bsdf_diffusion_sampling_tpu_torch.ops import cuda_build


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("bvh_build.cpp")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.bvh_build.argtypes = [f32p, f32p, ctypes.c_int64, ctypes.c_int, f32p, f32p, i32p, i32p, i64p, i32p]
    lib.bvh_build.restype = ctypes.c_int
    return lib


def build_bvh_native(
    lo: np.ndarray, hi: np.ndarray, max_leaf: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """Returns (bb_min, bb_max, left, count, prims, max_depth) trimmed to
    node count; max_depth is the deepest node's depth (root = 0)."""
    n = len(lo)
    cap = 2 * n
    bb_min = np.empty((cap, 3), np.float32)
    bb_max = np.empty((cap, 3), np.float32)
    left = np.empty(cap, np.int32)
    count = np.empty(cap, np.int32)
    prims = np.empty(n, np.int64)
    max_depth = np.zeros(1, np.int32)
    n_nodes = _lib().bvh_build(
        np.ascontiguousarray(lo, np.float32), np.ascontiguousarray(hi, np.float32),
        n, max_leaf, bb_min, bb_max, left, count, prims, max_depth,
    )
    return (bb_min[:n_nodes], bb_max[:n_nodes], left[:n_nodes], count[:n_nodes], prims,
            int(max_depth[0]))
