"""Mitsuba-serialized mesh loader + affine transforms (host-side numpy),
counterpart of the JAX package's `render/mesh.py`.

A "serialized" container: uint16 magic 0x041C, uint16 version, then one zlib
stream per mesh; a footer lists uint32 stream offsets and a uint32 mesh
count. Each decompressed mesh (format v3): uint32 flags (0x1000 = single
precision, 0x0001 = vertex normals, 0x0002 = texcoords), uint64 vertex_count,
uint64 face_count, then positions / normals / uvs / uint32 face indices.
`write_serialized` writes that format (version 3, single precision), so
scenes can be made procedurally.

Meshes load into numpy, get transformed to world space, and concatenate
into one flat triangle soup with per-triangle material ids.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from typing import List

import numpy as np

_MAGIC = 0x041C
_FLAG_NORMALS = 0x0001
_FLAG_TEXCOORDS = 0x0002
_FLAG_COLORS = 0x0008
_FLAG_SINGLE = 0x1000
_FLAG_DOUBLE = 0x2000


@dataclass
class Mesh:
    positions: np.ndarray  # (V, 3) float32
    normals: np.ndarray | None  # (V, 3)
    uvs: np.ndarray | None  # (V, 2)
    faces: np.ndarray  # (F, 3) int32


def load_serialized(path: str, shape_index: int) -> Mesh:
    with open(path, "rb") as f:
        raw = f.read()
    magic, version = struct.unpack_from("<HH", raw, 0)
    if magic != _MAGIC:
        raise ValueError(f"{path}: bad serialized magic {magic:#x}")
    total = len(raw)
    (count,) = struct.unpack_from("<I", raw, total - 4)
    offsets = list(struct.unpack_from(f"<{count}I", raw, total - 4 - 4 * count))
    offsets.append(total - 4 - 4 * count)
    if not 0 <= shape_index < count:
        raise IndexError(f"{path}: shape_index {shape_index} not in [0, {count})")
    start, end = offsets[shape_index] + 4, offsets[shape_index + 1]
    data = zlib.decompress(raw[start:end])

    (flags,) = struct.unpack_from("<I", data, 0)
    p = 4
    if version >= 4:  # v4+ adds a null-terminated name
        p = data.index(b"\0", p) + 1
    vc, fc = struct.unpack_from("<QQ", data, p)
    p += 16
    dtype = np.float64 if flags & _FLAG_DOUBLE else np.float32
    isize = np.dtype(dtype).itemsize

    def take(n_elems):
        nonlocal p
        arr = np.frombuffer(data, dtype=dtype, count=n_elems, offset=p)
        p += n_elems * isize
        return arr.astype(np.float32)

    positions = take(3 * vc).reshape(vc, 3)
    normals = take(3 * vc).reshape(vc, 3) if flags & _FLAG_NORMALS else None
    uvs = take(2 * vc).reshape(vc, 2) if flags & _FLAG_TEXCOORDS else None
    if flags & _FLAG_COLORS:
        take(3 * vc)  # vertex colors: skip
    faces = np.frombuffer(data, dtype=np.uint32, count=3 * fc, offset=p)
    return Mesh(positions, normals, uvs, faces.reshape(fc, 3).astype(np.int32))


def write_serialized(path: str, meshes: List[Mesh]) -> None:
    """Write meshes as a version-3, single-precision serialized file."""
    streams = []
    for m in meshes:
        flags = _FLAG_SINGLE | (_FLAG_NORMALS if m.normals is not None else 0) | (
            _FLAG_TEXCOORDS if m.uvs is not None else 0)
        parts = [struct.pack("<IQQ", flags, len(m.positions), len(m.faces)),
                 np.ascontiguousarray(m.positions, "<f4").tobytes()]
        if m.normals is not None:
            parts.append(np.ascontiguousarray(m.normals, "<f4").tobytes())
        if m.uvs is not None:
            parts.append(np.ascontiguousarray(m.uvs, "<f4").tobytes())
        parts.append(np.ascontiguousarray(m.faces, "<u4").tobytes())
        streams.append(struct.pack("<HH", _MAGIC, 3) + zlib.compress(b"".join(parts)))
    offsets, pos = [], 0
    for s in streams:
        offsets.append(pos)
        pos += len(s)
    with open(path, "wb") as f:
        f.write(b"".join(streams) + struct.pack(f"<{len(offsets)}I", *offsets)
                + struct.pack("<I", len(offsets)))


def transform_mesh(mesh: Mesh, to_world: np.ndarray) -> Mesh:
    """Apply a 4x4 affine transform (normals via inverse-transpose)."""
    m = to_world
    pos = mesh.positions @ m[:3, :3].T + m[:3, 3]
    normals = None
    if mesh.normals is not None:
        n_mat = np.linalg.inv(m[:3, :3]).T
        n = mesh.normals @ n_mat.T
        norm = np.linalg.norm(n, axis=-1, keepdims=True)
        normals = (n / np.maximum(norm, 1e-12)).astype(np.float32)
    return Mesh(pos.astype(np.float32), normals, mesh.uvs, mesh.faces)


@dataclass
class TriangleSoup:
    """World-space triangle arrays ready for the BVH build."""

    v0: np.ndarray  # (F, 3)
    e1: np.ndarray  # (F, 3) v1 - v0
    e2: np.ndarray  # (F, 3) v2 - v0
    n0: np.ndarray  # (F, 3) shading normals per corner
    n1: np.ndarray
    n2: np.ndarray
    uv0: np.ndarray  # (F, 2)
    uv1: np.ndarray
    uv2: np.ndarray
    material_id: np.ndarray  # (F,) int32


def build_soup(meshes: List[Mesh], material_ids: List[int]) -> TriangleSoup:
    parts = {k: [] for k in ("v0", "e1", "e2", "n0", "n1", "n2", "uv0", "uv1", "uv2", "mid")}
    for mesh, mid in zip(meshes, material_ids):
        f = mesh.faces
        p = mesh.positions
        v0, v1, v2 = p[f[:, 0]], p[f[:, 1]], p[f[:, 2]]
        if mesh.normals is not None:
            n = mesh.normals
            n0, n1, n2 = n[f[:, 0]], n[f[:, 1]], n[f[:, 2]]
        else:
            gn = np.cross(v1 - v0, v2 - v0)
            gn /= np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-12)
            n0 = n1 = n2 = gn
        if mesh.uvs is not None:
            uv = mesh.uvs
            uv0, uv1, uv2 = uv[f[:, 0]], uv[f[:, 1]], uv[f[:, 2]]
        else:
            uv0 = uv1 = uv2 = np.zeros((len(f), 2), np.float32)
        parts["v0"].append(v0)
        parts["e1"].append(v1 - v0)
        parts["e2"].append(v2 - v0)
        parts["n0"].append(n0)
        parts["n1"].append(n1)
        parts["n2"].append(n2)
        parts["uv0"].append(uv0)
        parts["uv1"].append(uv1)
        parts["uv2"].append(uv2)
        parts["mid"].append(np.full(len(f), mid, np.int32))
    cat = {k: np.concatenate(v).astype(np.float32 if k != "mid" else np.int32) for k, v in parts.items()}
    return TriangleSoup(cat["v0"], cat["e1"], cat["e2"], cat["n0"], cat["n1"], cat["n2"],
                        cat["uv0"], cat["uv1"], cat["uv2"], cat["mid"])
