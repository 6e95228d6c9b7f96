"""Closest-hit and any-hit traversal of the 8-wide BVH (`render/bvh8.py`):
kernel K5 and its plain PyTorch version.

K5 (`csrc/traverse8.cu`) replaces the JAX package's
`render/traverse8.py:251 _traverse_kernel` and `:63 _turn` (pallas_call
`:383`). The TPU kernel walks packets of S x 128 rays with one shared scalar
stack and G DMA slots; that scheme answers the TPU's lack of fast gathers
and is not carried over. Here one thread walks one ray with its own stack
of STACK8_DEPTH entries:
- inner block: slab-test the up-to-8 child rows against t_best
  (`tn <= tf && tf > 1e-5 && tn < t_best`) and push the hit children far
  to near by the ray's own direction sign along the node's sort axis, so
  the nearest pops first;
- leaf block: Moller-Trumbore against each triangle row (|det| > 1e-12,
  t > 1e-4, u, v >= 0, u + v <= 1, t < t_best); within a leaf, equal t
  goes to the largest prim id (`traverse8.py:145`); across blocks the
  first hit wins (strict <);
- any hit: a ray stops as soon as t_best < t_max * 0.9999, the threshold
  `occluded8` applies, so a hit in [0.9999 t_max, t_max) does not stop it;
- a ray that makes MAX_VISITS block visits, or overflows its stack, is
  counted as truncated (`traverse8.py:313`).

What bounds K5 on the card: the least time is the larger of the slab and
triangle operations over 67 TFLOP/s fp32 and the bytes over 3.35 TB/s (the
rays' 41 bytes in and 16 out each, the packed layout once; the
matpreview-size scene's is ~4 MB and stays in the 50 MB L2). At the
render's rays the two come out close, so either can bound a launch.
`chip_smoke.py` works the bound out from this module's plain walker, which
counts the node-block visits and triangle tests of the main path's rays
(`traverse8_plain(..., stats=True)`). The kernel runs far above that bound:
a ray's walk is a chain of dependent node visits and a warp runs as long
as its longest ray. K5 reads the packed layout of `render/bvh8.py`: a
node visit loads one 256-byte record of its 8 children's bounds and meta
words, 14 independent 16-byte loads, and a triangle one 48-byte record;
its stack is in local memory, and its warps are persistent, each taking
32 rays at a time from a counter. Both
versions round every product and sum separately (no FMA contraction in the
kernel) and push children in the same order, so they agree to the bit on
every ray. No PyTorch call computes a BVH traversal, so K5 has no library
yardstick.

The plain version walks the row table (`BVH8.table`) with per-ray stacks,
in lockstep over the rays that are still live, with the same push order,
tie rules and caps. A wrapper takes it for CPU tensors only; a CUDA tensor launches K5
or raises, and adds one to `launches["traverse8"]`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from bsdf_diffusion_sampling_tpu_torch.ops import cuda_build
from bsdf_diffusion_sampling_tpu_torch.render.bvh8 import BVH8, META_BASE_BITS, META_FLAGS_SHIFT, STACK8_DEPTH

INF = 1e30
MAX_VISITS = 8192  # block visits per ray before it is counted as truncated
_BASE_MASK = (1 << META_BASE_BITS) - 1

launches = {"traverse8": 0}


def reset_launches() -> None:
    launches["traverse8"] = 0


class Hit(NamedTuple):
    """The JAX package's `render/bvh.py:143-155` contract."""

    t: torch.Tensor  # (R,) hit distance; t_max (1e30 by default) on a miss
    prim: torch.Tensor  # (R,) int32 primitive index (reordered space), >= 0
    u: torch.Tensor  # (R,) barycentrics, 0 on a miss
    v: torch.Tensor
    # 0-dim bool tensor on the rays' device: True iff some ray hit the visit
    # cap or overflowed its stack (its result may be a false miss). Kept on
    # the device so a caller checks it once, not every bounce.
    truncated: torch.Tensor


class WalkStats(NamedTuple):
    """What the plain walker did, summed over the rays."""

    inner_visits: int  # inner blocks visited
    leaf_visits: int  # leaf blocks visited
    box_tests: int  # child slab tests
    tri_tests: int  # Moller-Trumbore tests


# ------------------------------------------------------------- plain version


def traverse8_plain(bvh: BVH8, ro: torch.Tensor, rd: torch.Tensor, ird: torch.Tensor, t_max: torch.Tensor,
                    active: torch.Tensor, any_hit: bool, stats: bool = False):
    """K5's function in plain PyTorch. `rd` must already be the wrapper's
    `rd_safe` and `ird` its reciprocal. Returns (t, prim, u, v, n_truncated)
    with the kernel's raw outputs: t_best (-1e30 for inactive rays), prim -1
    on a miss; plus a WalkStats when `stats`."""
    dev = ro.device
    r = ro.shape[0]
    table = bvh.table
    k8 = torch.arange(8, device=dev)
    t_best = torch.where(active, t_max, torch.full_like(t_max, -INF))
    t_stop = t_max * 0.9999 if any_hit else None
    prim = torch.full((r,), -1, dtype=torch.int32, device=dev)
    hu = torch.zeros(r, dtype=torch.float32, device=dev)
    hv = torch.zeros(r, dtype=torch.float32, device=dev)
    stack = torch.zeros((r, STACK8_DEPTH), dtype=torch.int64, device=dev)
    sp = torch.zeros(r, dtype=torch.int64, device=dev)
    cur = torch.full((r,), bvh.root_meta, dtype=torch.int64, device=dev)
    visits = torch.zeros(r, dtype=torch.int64, device=dev)
    trunc = torch.zeros(r, dtype=torch.bool, device=dev)
    live = torch.nonzero(active).squeeze(1)
    n_inner = n_leaf = n_box = n_tri = 0

    while live.numel():
        m = cur[live]
        base = m & _BASE_MASK
        flags = m >> META_FLAGS_SHIFT
        cnt = ((flags >> 3) & 7) + 1
        kmask = k8[None, :] < cnt[:, None]  # (L, 8)
        rows = table[base[:, None] + k8[None, :]]  # (L, 8, 16)
        is_leaf = (flags & 1) > 0
        tb = t_best[live][:, None]

        lf = torch.nonzero(is_leaf).squeeze(1)
        if lf.numel():
            ids = live[lf]
            b, km, tbl = rows[lf], kmask[lf], tb[lf]
            rox, roy, roz = (ro[ids, a][:, None] for a in range(3))
            rdx, rdy, rdz = (rd[ids, a][:, None] for a in range(3))
            v0x, v0y, v0z = b[..., 0], b[..., 1], b[..., 2]
            e1x, e1y, e1z = b[..., 3], b[..., 4], b[..., 5]
            e2x, e2y, e2z = b[..., 6], b[..., 7], b[..., 8]
            px = rdy * e2z - rdz * e2y
            py = rdz * e2x - rdx * e2z
            pz = rdx * e2y - rdy * e2x
            det = e1x * px + e1y * py + e1z * pz
            ok_det = det.abs() > 1e-12
            inv_det = torch.where(ok_det, 1.0 / det, torch.zeros_like(det))
            sx, sy, sz = rox - v0x, roy - v0y, roz - v0z
            u = (sx * px + sy * py + sz * pz) * inv_det
            qx = sy * e1z - sz * e1y
            qy = sz * e1x - sx * e1z
            qz = sx * e1y - sy * e1x
            v = (rdx * qx + rdy * qy + rdz * qz) * inv_det
            t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
            valid = km & ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-4) & (t < tbl)
            tc = torch.where(valid, t, torch.full_like(t, INF))
            tmin = tc.min(dim=1, keepdim=True).values
            # the last (largest prim id) of the rows at the leaf's least t
            kbest = torch.where(valid & (tc == tmin), k8[None, :], -1).max(dim=1, keepdim=True).values
            hit = kbest[:, 0] >= 0
            hid, kb = ids[hit], kbest[hit]
            t_best[hid] = tmin[hit, 0]
            prim[hid] = torch.gather(b[hit][..., 9], 1, kb)[:, 0].to(torch.int32)
            hu[hid] = torch.gather(u[hit], 1, kb)[:, 0]
            hv[hid] = torch.gather(v[hit], 1, kb)[:, 0]
            if stats:
                n_leaf += lf.numel()
                n_tri += int(cnt[lf].sum())

        inn = torch.nonzero(~is_leaf).squeeze(1)
        if inn.numel():
            ids = live[inn]
            b, km, tbl = rows[inn], kmask[inn], tb[inn]
            o, ir = ro[ids][:, None, :], ird[ids][:, None, :]
            t0 = (b[..., 0:3] - o) * ir
            t1 = (b[..., 3:6] - o) * ir
            lo_t, hi_t = torch.minimum(t0, t1), torch.maximum(t0, t1)
            tn = torch.maximum(torch.maximum(lo_t[..., 0], lo_t[..., 1]), lo_t[..., 2])
            tf = torch.minimum(torch.minimum(hi_t[..., 0], hi_t[..., 1]), hi_t[..., 2])
            hit = km & (tn <= tf) & (tf > 1e-5) & (tn < tbl)
            axis = (flags[inn] >> 1) & 3
            sign_pos = torch.gather(rd[ids], 1, axis[:, None].clamp(max=2))[:, 0] > 0
            # positive rays push children 7..0 (child 0 on top, popped
            # first), the others 0..7: a child's slot is the number of hit
            # children pushed before it
            h = hit.to(torch.int64)
            before = torch.where(sign_pos[:, None], h.flip(1).cumsum(1).flip(1) - h, h.cumsum(1) - h)
            slot = sp[ids][:, None] + before
            meta = (b[..., 13].to(torch.int64) << META_FLAGS_SHIFT) | b[..., 12].to(torch.int64)
            put = hit & (slot < STACK8_DEPTH)
            ri, ki = torch.nonzero(put, as_tuple=True)
            stack[ids[ri], slot[ri, ki]] = meta[ri, ki]
            trunc[ids] |= (hit & ~put).any(1)
            sp[ids] = torch.clamp(sp[ids] + h.sum(1), max=STACK8_DEPTH)
            if stats:
                n_inner += inn.numel()
                n_box += int(cnt[inn].sum())

        visits[live] += 1
        s = sp[live]
        ended = s == 0
        if any_hit:
            ended |= t_best[live] < t_stop[live]
        capped = ~ended & (visits[live] >= MAX_VISITS)
        trunc[live[capped]] = True
        ended |= capped
        live = live[~ended]
        top = sp[live] - 1
        cur[live] = stack[live, top]
        sp[live] = top

    out = (t_best, prim, hu, hv, int(trunc.sum()))
    return (out + (WalkStats(n_inner, n_leaf, n_box, n_tri),)) if stats else out


# ------------------------------------------------------------------ wrapper


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("traverse8.cu")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.bsdf_traverse8.argtypes = [P, P, ctypes.c_uint, P, P, P, P, P, I, I, P, P, P, P, P, P, P]
    lib.bsdf_traverse8.restype = I
    lib.bsdf_traverse8_kernel_info.argtypes = [I, P]
    lib.bsdf_traverse8_kernel_info.restype = I
    return lib


def kernel_resources() -> dict:
    """{instantiation: {registers, local_bytes, blocks_per_sm, shared_bytes}}
    of K5 (closest and any hit) at 128 threads a block, on the current card."""
    out = {}
    for which, name in enumerate(("K5 closest hit", "K5 any hit")):
        buf = (ctypes.c_int * 4)()
        rc = _lib().bsdf_traverse8_kernel_info(which, ctypes.cast(buf, ctypes.c_void_p))
        if rc != 0:
            raise RuntimeError(f"bsdf_traverse8_kernel_info({which}): CUDA error {rc}")
        out[name] = dict(zip(("registers", "local_bytes", "blocks_per_sm", "shared_bytes"), buf))
    return out


def _check(t: torch.Tensor, name: str, shape: tuple, dtype, device) -> None:
    if t.device != device or t.dtype != dtype or not t.is_contiguous() or tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected a contiguous {dtype} tensor of shape {shape} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def traverse8(bvh: BVH8, ro: torch.Tensor, rd: torch.Tensor, ird: torch.Tensor, t_max: torch.Tensor,
              active: torch.Tensor, any_hit: bool):
    """Raw traversal, (t, prim, u, v, n_truncated) as `traverse8_plain`
    returns them; n_truncated is an int on the CPU and a (1,) int32 tensor
    on the card."""
    dev = ro.device
    if dev.type == "cpu":
        return traverse8_plain(bvh, ro, rd, ird, t_max, active, any_hit)
    if dev.type != "cuda":
        raise ValueError(f"traverse8 runs on CUDA or CPU tensors, got {dev}")
    r = ro.shape[0]
    for name, x in (("ro", ro), ("rd", rd), ("ird", ird)):
        _check(x, name, (r, 3), torch.float32, dev)
    _check(t_max, "t_max", (r,), torch.float32, dev)
    _check(active, "active", (r,), torch.bool, dev)
    _check(bvh.nodes, "nodes", (bvh.nodes.shape[0], 64), torch.int32, dev)
    _check(bvh.tris, "tris", (bvh.tris.shape[0], 12), torch.float32, dev)
    t = torch.empty(r, dtype=torch.float32, device=dev)
    prim = torch.empty(r, dtype=torch.int32, device=dev)
    u = torch.empty(r, dtype=torch.float32, device=dev)
    v = torch.empty(r, dtype=torch.float32, device=dev)
    n_trunc = torch.zeros(1, dtype=torch.int32, device=dev)
    next_ray = torch.zeros(1, dtype=torch.int32, device=dev)  # K5's persistent warps take rays from it
    if r == 0:
        return t, prim, u, v, n_trunc
    with torch.cuda.device(dev):
        rc = _lib().bsdf_traverse8(
            bvh.nodes.data_ptr(), bvh.tris.data_ptr(), bvh.packed_root, ro.data_ptr(), rd.data_ptr(),
            ird.data_ptr(), t_max.data_ptr(), active.data_ptr(), r, int(any_hit), t.data_ptr(), prim.data_ptr(),
            u.data_ptr(), v.data_ptr(), n_trunc.data_ptr(), next_ray.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"traverse8: CUDA error {rc} at launch")
    launches["traverse8"] += 1
    return t, prim, u, v, n_trunc


def safe_dir(rd: torch.Tensor):
    """(rd_safe, 1 / rd_safe): components under 1e-12 in magnitude pushed to
    +-1e-12 (`traverse8.py:450-452`)."""
    tiny = torch.where(rd >= 0, torch.full_like(rd, 1e-12), torch.full_like(rd, -1e-12))
    rd_safe = torch.where(rd.abs() < 1e-12, tiny, rd)
    return rd_safe, 1.0 / rd_safe


def intersect8(bvh: BVH8, ro: torch.Tensor, rd: torch.Tensor, t_max=INF, active=None,
               any_hit: bool = False) -> Hit:
    """Closest hit (or, with any_hit, some hit closer than 0.9999 t_max)
    under the Hit contract: active rays that miss keep t == t_max, inactive
    rays return t_max untouched, prim clamps to >= 0, u/v are 0 on a miss."""
    r = ro.shape[0]
    dev = ro.device
    if torch.is_tensor(t_max):
        t_max_arr = t_max.to(torch.float32).contiguous()
    else:
        t_max_arr = torch.full((r,), float(t_max), dtype=torch.float32, device=dev)
    act = torch.ones(r, dtype=torch.bool, device=dev) if active is None else active.contiguous()
    rd_safe, ird = safe_dir(rd.to(torch.float32))
    t, prim, u, v, n_trunc = traverse8(bvh, ro.to(torch.float32).contiguous(), rd_safe.contiguous(),
                                       ird.contiguous(), t_max_arr, act, any_hit)
    miss = prim < 0
    zero = torch.zeros_like(u)
    truncated = n_trunc[0] > 0 if torch.is_tensor(n_trunc) else torch.tensor(n_trunc > 0, device=dev)
    return Hit(t=torch.where(act, t, t_max_arr), prim=torch.clamp(prim, min=0),
               u=torch.where(miss, zero, u), v=torch.where(miss, zero, v), truncated=truncated)


def occluded8(bvh: BVH8, ro, rd, t_max, active=None) -> torch.Tensor:
    """Boolean shadow query through the any-hit traversal."""
    t_max = t_max if torch.is_tensor(t_max) else torch.full((ro.shape[0],), float(t_max), device=ro.device)
    hit = intersect8(bvh, ro, rd, t_max, active=active, any_hit=True)
    return hit.t < t_max * 0.9999
