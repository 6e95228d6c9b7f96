"""8-wide BVH for the traversal kernel (`render/traverse8.py`), counterpart of
the JAX package's `render/bvh8.py`.

Built by collapsing the binary SAH tree from the native builder
(`native/bvhlib.py`): subtrees with <= max_leaf prims become fat leaves
(their prims are contiguous because the binary build reorders prims in DFS
leaf order), and the remaining inner structure is merged greedily
(largest-surface-area child expanded first) into nodes of up to 8
children. Children are sorted along the axis of largest centroid spread;
the axis rides in the parent's packed meta so traversal can push the far
children first along the ray's own direction.

Unified row table, float32, 16 lanes per row (64 bytes):
  node row:  lanes 0:3 lo, 3:6 hi, 12 child base row, 13 flags
  tri row:   lanes 0:3 v0, 3:6 e1, 6:9 e2, 9 prim_id
  flags = ((count-1) << 3) | (axis << 1) | is_leaf; base exact as f32 up
  to 2^24 rows. For a node, rows [base, base+count) are its children's
  node rows; for a leaf they are tri rows.
The JAX table has 128 lanes a row, the TPU's DMA tile; lanes 16: are zero
there, so this table is its first 16 lanes, row for row.

Packed layout, read by the traversal kernel K5 and built from the table by
`pack_bvh8` (the plain walker reads the table):
  nodes (n_blocks, 64) int32, one 256-byte record a child block (the root's
    and every inner node's), structure of arrays: lo x, lo y, lo z, hi x,
    hi y, hi z of the up-to-8 children (8 lanes each, float32 bits copied
    from the table), then the 8 children's meta words, then 8 lanes of 0;
    lanes of children past the block's count are 0;
  tris (n_prims, 12) float32, 48 bytes a triangle in leaf order: v0, e1,
    e2 and the prim id (the table's tri row lanes 0:10; lanes 10:12 are 0).
A meta word keeps the table's flags and points into these arrays: an inner
child's base is its child block's record, a leaf's base its first
triangle. Records are in the order of their blocks' first table rows.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from bsdf_diffusion_sampling_tpu_torch.native.bvhlib import build_bvh_native
from bsdf_diffusion_sampling_tpu_torch.render.mesh import TriangleSoup

MAX_LEAF8 = 8
ROW_LANES = 16
# packed stack-entry/meta word (int32): low 25 bits = base row, then
# (count-1) << 3 | axis << 1 | leaf in bits 25..30 (sign bit untouched).
# In the TABLE the word is split over two f32 lanes (12: base, 13: flags).
META_BASE_BITS = 25
META_FLAGS_SHIFT = 25
# stack entries per ray in the traversal: the collapse keeps the 8-wide
# depth small, and each level pushes at most 8
STACK8_DEPTH = 64


class BVH8(NamedTuple):
    table: torch.Tensor  # (n_rows, 16) float32 unified node+tri rows
    root_meta: int  # packed meta of the root child block
    n_rows: int
    tri0: int  # first tri row; prim p's row is table[tri0 + p]
    max_depth: int  # 8-wide depth (stack-need diagnostic)
    # per-prim attribute rows in REORDERED (perm) space, (n_prims, 16):
    # [n0(0:3), n1(3:6), n2(6:9), uv0(9:11), uv1(11:13), uv2(13:15),
    #  material_id(15)]
    attr_rows: torch.Tensor
    nodes: torch.Tensor  # (n_blocks, 64) int32 packed child-block records
    tris: torch.Tensor  # (n_prims, 12) float32 packed triangles
    packed_root: int  # meta word of the root block in the packed layout

    @property
    def device(self) -> torch.device:
        return self.table.device

    @property
    def packed_bytes(self) -> int:
        return (self.nodes.numel() + self.tris.numel()) * 4

    def to(self, device) -> "BVH8":
        return self._replace(table=self.table.to(device), attr_rows=self.attr_rows.to(device),
                             nodes=self.nodes.to(device), tris=self.tris.to(device))


def pack_flags(count: int, axis: int, leaf: bool) -> int:
    assert 0 < count <= 8 and 0 <= axis < 4
    return ((count - 1) << 3) | (axis << 1) | int(leaf)


def pack_meta(base: int, count: int, axis: int, leaf: bool) -> int:
    assert 0 <= base < (1 << META_BASE_BITS)
    return (pack_flags(count, axis, leaf) << META_FLAGS_SHIFT) | base


def build_bvh8(soup: TriangleSoup, max_leaf: int = MAX_LEAF8) -> BVH8:
    """Collapse the native binary SAH tree into the 8-wide row table (CPU
    tensors; move with `.to(device)`)."""
    v0, e1, e2 = soup.v0, soup.e1, soup.e2
    lo = np.minimum(np.minimum(v0, v0 + e1), v0 + e2)
    hi = np.maximum(np.maximum(v0, v0 + e1), v0 + e2)
    # finer binary granularity (max_leaf 2) so fat-leaf chunking can hit
    # close to `max_leaf` prims per 8-leaf
    bb_min, bb_max, left, count, perm, _ = build_bvh_native(lo, hi, 2)
    n_bin = len(count)

    # subtree prim counts + first prim (DFS preorder: left child = i+1,
    # right child = left[i]; leaf ranges contiguous in perm order)
    first = np.zeros(n_bin, np.int64)
    nprims = np.zeros(n_bin, np.int64)
    order = []  # post-order
    stack = [(0, False)]
    while stack:
        i, processed = stack.pop()
        if processed:
            order.append(i)
            continue
        stack.append((i, True))
        if count[i] == 0:
            stack.append((int(left[i]), False))
            stack.append((i + 1, False))
    for i in order:
        if count[i] > 0:
            first[i] = left[i]
            nprims[i] = count[i]
        else:
            l, r = i + 1, int(left[i])
            first[i] = first[l]
            nprims[i] = nprims[l] + nprims[r]

    ext = np.maximum(bb_max - bb_min, 0.0)
    area = ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 2] * ext[:, 0]

    def is_leaf(i: int) -> bool:
        return nprims[i] <= max_leaf or count[i] > 0

    def collapse_children(i: int) -> list[int]:
        """Binary node i (not a leaf) -> up to 8 binary-node children."""
        kids = [i + 1, int(left[i])]
        while len(kids) < 8:
            # expand the largest-area non-fat-leaf child
            best, best_a = -1, -1.0
            for k, c in enumerate(kids):
                if nprims[c] > max_leaf and area[c] > best_a:
                    best, best_a = k, area[c]
            if best < 0:
                break
            c = kids.pop(best)
            kids.extend([c + 1, int(left[c])])
        return kids

    def sort_kids(kids: list[int]) -> tuple[list[int], int]:
        """Order children along the axis of largest centroid spread."""
        cen = 0.5 * (bb_min[kids] + bb_max[kids])
        axis = int(np.argmax(cen.max(0) - cen.min(0)))
        order = np.argsort(cen[:, axis], kind="stable")
        return [kids[int(j)] for j in order], axis

    # BFS allocation so each node's children occupy consecutive rows; node
    # rows first, tri rows after
    n_node_rows = 0
    row_of: dict[int, int] = {}

    def alloc_block(kids: list[int]) -> int:
        nonlocal n_node_rows
        base = n_node_rows
        for c in kids:
            row_of[c] = n_node_rows
            n_node_rows += 1
        return base

    if is_leaf(0):
        root_kids, root_axis = [0], 0
    else:
        root_kids, root_axis = sort_kids(collapse_children(0))
    root_base = alloc_block(root_kids)
    depth_of = {c: 1 for c in root_kids}
    max_depth = 1
    queue = list(root_kids)
    child_info: dict[int, tuple[list[int], int]] = {}
    while queue:
        i = queue.pop(0)
        if is_leaf(i):
            continue
        kids, axis = sort_kids(collapse_children(i))
        alloc_block(kids)
        child_info[i] = (kids, axis)
        d = depth_of[i] + 1
        max_depth = max(max_depth, d)
        for c in kids:
            depth_of[c] = d
        queue.extend(kids)

    n_prims = len(perm)
    n_rows = n_node_rows + n_prims
    # the JAX table's padding (an 8-row DMA window stays in bounds), kept so
    # the two tables match row for row
    n_rows_padded = ((n_rows + 7) // 8) * 8 + 8
    if n_rows_padded >= (1 << 24):
        raise ValueError(f"BVH8 table has {n_rows_padded} rows; the f32 base lane is exact only below 2^24")
    table = np.zeros((n_rows_padded, ROW_LANES), np.float32)
    tri0 = n_node_rows
    table[tri0:tri0 + n_prims, 0:3] = np.asarray(soup.v0)[perm]
    table[tri0:tri0 + n_prims, 3:6] = np.asarray(soup.e1)[perm]
    table[tri0:tri0 + n_prims, 6:9] = np.asarray(soup.e2)[perm]
    table[tri0:tri0 + n_prims, 9] = np.arange(n_prims, dtype=np.float32)

    for i, row in row_of.items():
        table[row, 0:3] = bb_min[i]
        table[row, 3:6] = bb_max[i]
        if is_leaf(i):
            base_v, flags_v = tri0 + int(first[i]), pack_flags(int(nprims[i]), 0, True)
        else:
            kids, axis = child_info[i]
            base_v, flags_v = row_of[kids[0]], pack_flags(len(kids), axis, False)
        table[row, 12] = float(base_v)
        table[row, 13] = float(flags_v)

    # root_meta always describes an INNER block (traversal slab-tests its
    # rows as node rows): a single-leaf scene becomes a one-child block
    root_meta = pack_meta(root_base, len(root_kids), root_axis, False)

    attr = np.zeros((n_prims, 16), np.float32)
    for col, name in ((0, "n0"), (3, "n1"), (6, "n2")):
        attr[:, col:col + 3] = np.asarray(getattr(soup, name))[perm]
    for col, name in ((9, "uv0"), (11, "uv1"), (13, "uv2")):
        attr[:, col:col + 2] = np.asarray(getattr(soup, name))[perm]
    attr[:, 15] = np.asarray(soup.material_id)[perm]

    nodes, tris, packed_root = pack_bvh8(table, root_meta, tri0, n_prims)
    return BVH8(
        table=torch.from_numpy(table),
        root_meta=root_meta,
        n_rows=n_rows_padded,
        tri0=tri0,
        max_depth=max_depth,
        attr_rows=torch.from_numpy(attr),
        nodes=torch.from_numpy(nodes),
        tris=torch.from_numpy(tris),
        packed_root=packed_root,
    )


def pack_bvh8(table: np.ndarray, root_meta: int, tri0: int, n_prims: int):
    """The packed layout of the module docstring from a row table:
    (nodes, tris, packed root meta)."""
    base = table[:tri0, 12].astype(np.int64)
    flags = table[:tri0, 13].astype(np.int64)
    leaf = (flags & 1) > 0
    root_base, root_flags = root_meta & ((1 << META_BASE_BITS) - 1), root_meta >> META_FLAGS_SHIFT
    root_cnt = ((root_flags >> 3) & 7) + 1
    # a block is (first table row, count): the root's and each inner row's
    block_base = np.concatenate([[root_base], base[~leaf]])
    block_cnt = np.concatenate([[root_cnt], ((flags[~leaf] >> 3) & 7) + 1])
    order = np.argsort(block_base, kind="stable")
    block_base, block_cnt = block_base[order], block_cnt[order]
    if np.any(np.diff(block_base) <= 0):
        raise ValueError("BVH8 child blocks must start at distinct rows")
    record = np.searchsorted(block_base, base)
    meta = (flags << META_FLAGS_SHIFT) | np.where(leaf, base - tri0, record)

    k8 = np.arange(8)
    valid = k8[None, :] < block_cnt[:, None]
    rows = np.where(valid, block_base[:, None] + k8[None, :], 0)
    bits = table[:tri0].view(np.int32)
    nodes = np.zeros((len(block_base), 64), np.int32)
    for lane in range(6):  # lo x, y, z, hi x, y, z
        nodes[:, 8 * lane:8 * lane + 8] = np.where(valid, bits[rows, lane], 0)
    nodes[:, 48:56] = np.where(valid, meta[rows], 0)

    tris = np.zeros((n_prims, 12), np.float32)
    tris[:, :10] = table[tri0:tri0 + n_prims, :10]
    packed_root = (int(root_flags) << META_FLAGS_SHIFT) | int(np.searchsorted(block_base, root_base))
    return nodes, tris, packed_root
