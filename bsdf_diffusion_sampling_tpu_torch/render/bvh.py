"""Binary BVH: the native build flattened into a gather-packed node table,
and a lockstep closest-hit / any-hit walk in plain PyTorch, counterpart of
the JAX package's `render/bvh.py`.

The tree comes from the native binned-SAH builder (`native/bvhlib.py`) with
leaves of at most MAX_LEAF triangles, primitives reordered so leaves span
contiguous ranges. Each node row of `packed` (N, 68) holds what a visit
needs: lanes 0:12 both children's boxes (lo_l hi_l lo_r hi_r), 12 the right
child's index, 13 the leaf's triangle count (0 for an inner node), 14 its
first triangle, 16:64 the leaf's triangles as [v0 e1 e2] (padding slots
have zero edges, so they always miss) and 64:68 their reordered prim ids.
The left child of node i is node i + 1.

The walk keeps a stack of STACK_DEPTH (node, entry t) pairs a ray. Each
iteration every live ray pops one entry, skips it if its entry t is no
longer below t_best, tests the leaf's triangles (Moller-Trumbore: |det| >
1e-12, u, v >= 0, u + v <= 1, t > 1e-4, t < t_best) or slab-tests both
children of an inner node and pushes the hit ones far first. Only the rays
still live take part in an iteration. A ray still live after 64 *
STACK_DEPTH iterations leaves its result partial, which the `truncated`
flag reports. With `any_hit` a ray ends at its first accepted hit closer
than its t_max.

There is no kernel here, in this package or the JAX one: the 8-wide BVH
and its kernel K5 (`render/traverse8.py`) serve the renders. A scene built
with `wide=False` (`render/scene.py`) carries this tree instead, and the
integrator then walks it, on whichever device its tensors are.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from bsdf_diffusion_sampling_tpu_torch.native.bvhlib import build_bvh_native
from bsdf_diffusion_sampling_tpu_torch.render.mesh import TriangleSoup
from bsdf_diffusion_sampling_tpu_torch.render.traverse8 import Hit

MAX_LEAF = 4
STACK_DEPTH = 48
MAX_ITERS = 64 * STACK_DEPTH
INF = 1e30


class BVH(NamedTuple):
    bb_min: torch.Tensor  # (N, 3)
    bb_max: torch.Tensor  # (N, 3)
    left: torch.Tensor  # (N,) int32: inner node, its right child; leaf, its first prim
    count: torch.Tensor  # (N,) int32: 0 for an inner node, else the leaf's prim count
    packed: torch.Tensor  # (N, 68) float32 node rows (module docstring)
    # per-prim attribute rows in reordered space, (n_prims, 16), the layout
    # of `render/bvh8.py::BVH8.attr_rows`: n0, n1, n2, uv0, uv1, uv2, material id
    attr_rows: torch.Tensor
    max_depth: int

    @property
    def device(self) -> torch.device:
        return self.packed.device

    def to(self, device) -> "BVH":
        return self._replace(bb_min=self.bb_min.to(device), bb_max=self.bb_max.to(device),
                             left=self.left.to(device), count=self.count.to(device),
                             packed=self.packed.to(device), attr_rows=self.attr_rows.to(device))


def build_bvh(soup: TriangleSoup) -> BVH:
    """The native binary build, flattened (CPU tensors; move with `.to`)."""
    v0, e1, e2 = soup.v0, soup.e1, soup.e2
    if len(v0) >= (1 << 24):  # child and prim indices are stored as float32
        raise ValueError(f"scene has {len(v0)} primitives; the float32-packed node table supports < 2^24")
    lo = np.minimum(np.minimum(v0, v0 + e1), v0 + e2)
    hi = np.maximum(np.maximum(v0, v0 + e1), v0 + e2)
    bb_min, bb_max, left, count, perm, max_depth = build_bvh_native(lo, hi, MAX_LEAF)
    if max_depth + 1 > STACK_DEPTH:  # the ordered walk pushes two children a pop
        raise ValueError(f"BVH depth {max_depth} exceeds the walk's STACK_DEPTH {STACK_DEPTH}")
    n_nodes = len(count)
    v0r, e1r, e2r = (np.asarray(a)[perm] for a in (v0, e1, e2))
    n_prims = len(v0r)

    packed = np.zeros((n_nodes, 68), np.float32)
    inner = count == 0
    l_child = np.where(inner, np.arange(n_nodes) + 1, 0)
    r_child = np.where(inner, left, 0)
    packed[:, 0:3] = bb_min[l_child]
    packed[:, 3:6] = bb_max[l_child]
    packed[:, 6:9] = bb_min[r_child]
    packed[:, 9:12] = bb_max[r_child]
    packed[:, 12] = r_child
    packed[:, 13] = count
    packed[:, 14] = left
    leaf = np.nonzero(~inner)[0]
    for k in range(MAX_LEAF):
        prim = np.minimum(left[leaf] + k, n_prims - 1)
        valid = (k < count[leaf])[:, None]
        base = 16 + 12 * k
        packed[leaf, base:base + 3] = v0r[prim]
        packed[leaf, base + 3:base + 6] = np.where(valid, e1r[prim], 0.0)
        packed[leaf, base + 6:base + 9] = np.where(valid, e2r[prim], 0.0)
        packed[leaf, 64 + k] = prim

    attr = np.zeros((n_prims, 16), np.float32)
    for col, name in ((0, "n0"), (3, "n1"), (6, "n2")):
        attr[:, col:col + 3] = np.asarray(getattr(soup, name))[perm]
    for col, name in ((9, "uv0"), (11, "uv1"), (13, "uv2")):
        attr[:, col:col + 2] = np.asarray(getattr(soup, name))[perm]
    attr[:, 15] = np.asarray(soup.material_id)[perm]
    return BVH(bb_min=torch.from_numpy(np.ascontiguousarray(bb_min)),
               bb_max=torch.from_numpy(np.ascontiguousarray(bb_max)),
               left=torch.from_numpy(left.astype(np.int32)), count=torch.from_numpy(count.astype(np.int32)),
               packed=torch.from_numpy(packed), attr_rows=torch.from_numpy(attr), max_depth=int(max_depth))


def _slab(lo, hi, ro, inv_rd, t_best):
    """Slab test of per-ray boxes (L, 3): (hit, t_near)."""
    t0 = (lo - ro) * inv_rd
    t1 = (hi - ro) * inv_rd
    t_near = torch.minimum(t0, t1).amax(-1)
    t_far = torch.maximum(t0, t1).amin(-1)
    return (t_near <= t_far) & (t_far > 1e-5) & (t_near < t_best), t_near


def intersect(bvh: BVH, ro: torch.Tensor, rd: torch.Tensor, t_max=INF, active=None,
              any_hit: bool = False) -> Hit:
    """Closest hit (or, with any_hit, the first hit found closer than
    t_max) of rays (R, 3) under the `Hit` contract of `render/traverse8.py`:
    t is t_max for a miss and for an inactive ray, prim (reordered space)
    and u, v are 0 on a miss."""
    r = ro.shape[0]
    dev = ro.device
    ro, rd = ro.to(torch.float32), rd.to(torch.float32)
    tiny = torch.where(rd >= 0, torch.full_like(rd, 1e-12), torch.full_like(rd, -1e-12))
    inv_rd = 1.0 / torch.where(rd.abs() < 1e-12, tiny, rd)
    if torch.is_tensor(t_max):
        t_max_arr = t_max.to(torch.float32)
    else:
        t_max_arr = torch.full((r,), float(t_max), dtype=torch.float32, device=dev)
    node_stk = torch.zeros((r, STACK_DEPTH + 1), dtype=torch.int64, device=dev)
    t_stk = torch.full((r, STACK_DEPTH + 1), -INF, dtype=torch.float32, device=dev)
    ptr = torch.ones(r, dtype=torch.int64, device=dev) if active is None else active.to(torch.int64)
    t_best = t_max_arr.clone()
    prim_best = torch.zeros(r, dtype=torch.int32, device=dev)
    u_best = torch.zeros(r, dtype=torch.float32, device=dev)
    v_best = torch.zeros(r, dtype=torch.float32, device=dev)
    packed = bvh.packed

    it = 0
    live = torch.nonzero(ptr > 0).squeeze(1)
    while live.numel() and it < MAX_ITERS:
        p = ptr[live] - 1
        node = node_stk[live, p]
        visit = t_stk[live, p] < t_best[live]
        row = packed[node]  # (L, 68): both children's boxes, or the leaf's triangles
        cnt = row[:, 13].to(torch.int64)
        is_leaf, is_inner = visit & (cnt > 0), visit & (cnt == 0)
        o, d, tb = ro[live], rd[live], t_best[live]
        ox, oy, oz = o.unbind(-1)
        dx, dy, dz = d.unbind(-1)
        pb, ub, vb = prim_best[live], u_best[live], v_best[live]
        for k in range(MAX_LEAF):
            # Moller-Trumbore, each product and sum rounded in the order of
            # the 8-wide walkers (`render/traverse8.py`): the same triangle
            # gives them the same t, u, v to the bit
            v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = row[:, 16 + 12 * k:25 + 12 * k].unbind(-1)
            px = dy * e2z - dz * e2y
            py = dz * e2x - dx * e2z
            pz = dx * e2y - dy * e2x
            det = e1x * px + e1y * py + e1z * pz
            ok_det = det.abs() > 1e-12
            inv_det = torch.where(ok_det, 1.0 / det, 0.0)
            sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
            u = (sx * px + sy * py + sz * pz) * inv_det
            qx = sy * e1z - sz * e1y
            qy = sz * e1x - sx * e1z
            qz = sx * e1y - sy * e1x
            v = (dx * qx + dy * qy + dz * qz) * inv_det
            t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
            ok = is_leaf & ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-4) & (t < tb)
            tb = torch.where(ok, t, tb)
            pb = torch.where(ok, row[:, 64 + k].to(torch.int32), pb)
            ub = torch.where(ok, u, ub)
            vb = torch.where(ok, v, vb)
        if any_hit:  # the first accepted hit ends the ray: no more pops, no pushes
            done = tb < t_max_arr[live]
            p = torch.where(done, 0, p)
            is_inner = is_inner & ~done

        inv = inv_rd[live]
        hit_l, tn_l = _slab(row[:, 0:3], row[:, 3:6], o, inv, tb)
        hit_r, tn_r = _slab(row[:, 6:9], row[:, 9:12], o, inv, tb)
        hit_l, hit_r = hit_l & is_inner, hit_r & is_inner
        l_child, r_child = node + 1, row[:, 12].to(torch.int64)
        l_near = tn_l <= tn_r
        for c, tn, h in ((torch.where(l_near, r_child, l_child), torch.where(l_near, tn_r, tn_l),
                          torch.where(l_near, hit_r, hit_l)),
                         (torch.where(l_near, l_child, r_child), torch.where(l_near, tn_l, tn_r),
                          torch.where(l_near, hit_l, hit_r))):  # far first, so the near child pops first
            slot = torch.where(h & (p < STACK_DEPTH), p, STACK_DEPTH)  # the last column takes no-pushes
            node_stk[live, slot] = c
            t_stk[live, slot] = tn
            p = torch.where(h, torch.clamp(p + 1, max=STACK_DEPTH), p)

        ptr[live] = p
        t_best[live], prim_best[live], u_best[live], v_best[live] = tb, pb, ub, vb
        live = live[p > 0]
        it += 1
    truncated = torch.tensor(bool(live.numel()), device=dev)
    return Hit(t=t_best, prim=prim_best, u=u_best, v=v_best, truncated=truncated)


def occluded(bvh: BVH, ro: torch.Tensor, rd: torch.Tensor, t_max, active=None) -> torch.Tensor:
    """Boolean shadow query: some hit closer than 0.9999 t_max."""
    t_max = t_max if torch.is_tensor(t_max) else torch.full((ro.shape[0],), float(t_max), device=ro.device)
    return intersect(bvh, ro, rd, t_max, active=active, any_hit=True).t < t_max * 0.9999
