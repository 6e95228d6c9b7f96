"""Readers of the raw scene files, written for the benchmark's reference:
the Mitsuba-XML subset the procedural matpreview scene uses, the
`.serialized` mesh container, a ZIP-compressed half-float EXR and the RGL
tensor file. Plain numpy and the standard library; nothing of the program.
"""

from __future__ import annotations

import math
import os
import struct
import xml.etree.ElementTree as ET
import zlib

import numpy as np


def _floats(s: str) -> list:
    return [float(v) for v in s.replace(",", " ").split()]


def _rotation(axis, angle_deg: float) -> np.ndarray:
    """Rodrigues' rotation about `axis` as a 4 x 4 matrix."""
    x, y, z = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    a = math.radians(angle_deg)
    c, s = math.cos(a), math.sin(a)
    k = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
    m = np.eye(4)
    m[:3, :3] = c * np.eye(3) + s * k + (1 - c) * np.outer([x, y, z], [x, y, z])
    return m


def _transform(elem) -> np.ndarray:
    """Children composed in document order, each applied after the last."""
    m = np.eye(4)
    if elem is None:
        return m
    for child in elem:
        tag = child.tag.lower()
        op = np.eye(4)
        if tag == "translate":
            op[:3, 3] = [float(child.get(k, 0)) for k in "xyz"]
        elif tag == "scale":
            op = np.diag([float(child.get(k, 1)) for k in "xyz"] + [1.0])
        elif tag == "rotate":
            op = _rotation([float(child.get(k, 0)) for k in "xyz"], float(child.get("angle")))
        elif tag == "lookat":
            continue
        else:
            raise ValueError(f"the reference reads no <{tag}> transform")
        m = op @ m
    return m


def _prop(elem, name: str, defaults: dict):
    for child in elem:
        if child.get("name", "").replace("_", "").lower() == name:
            v = child.get("value")
            return defaults.get(v[1:], v) if v and v.startswith("$") else v
    return None


def read_scene_xml(path: str) -> dict:
    """The matpreview dialect `write_scene` emits: camera, envmap, shapes.
    Each shape's material is "plane" (a textured diffuse), "diffuse" or
    "ball" (the `mybsdf` hook, with its filename or table idx and albedo)."""
    root = ET.parse(path).getroot()
    defaults = {d.get("name"): d.get("value") for d in root.findall("default")}
    sensor = root.find("sensor")
    look = next(c for c in sensor.find("transform") if c.tag.lower() == "lookat")
    film = sensor.find("film")
    cam = {"origin": _floats(look.get("origin")), "target": _floats(look.get("target")),
           "up": _floats(look.get("up")), "fov": float(_prop(sensor, "fov", defaults)),
           "width": int(_prop(film, "width", defaults)), "height": int(_prop(film, "height", defaults))}
    env, lights = None, []
    for em in root.findall("emitter"):
        if em.get("type") == "envmap":
            env = {"file": os.path.join(os.path.dirname(path), _prop(em, "filename", defaults)),
                   "to_world": _transform(em.find("transform")),
                   "scale": float(_prop(em, "scale", defaults) or 1.0)}
        elif em.get("type") == "point":
            lights.append(_floats(_prop(em, "position", defaults)) + _floats(_prop(em, "intensity", defaults)))
    mats = {}
    for b in root.findall("bsdf"):
        if b.get("type") == "mybsdf":
            idx = _prop(b, "idx", defaults)
            mats[b.get("id")] = {"kind": "ball", "filename": _prop(b, "filename", defaults),
                                 "idx": None if idx is None else int(idx),
                                 "albedo": _floats(_prop(b, "albedo", defaults) or "1 1 1")}
        else:
            mats[b.get("id")] = {"kind": "plane" if b.find("ref") is not None else "diffuse"}
    shapes = []
    for sh in root.findall("shape"):
        ref = next(r for r in sh.findall("ref"))
        shapes.append({"file": os.path.join(os.path.dirname(path), _prop(sh, "filename", defaults)),
                       "index": int(_prop(sh, "shapeindex", defaults) or 0),
                       "to_world": _transform(sh.find("transform")), "material": mats[ref.get("id")]})
    return {"camera": cam, "envmap": env, "lights": lights, "shapes": shapes}


def read_serialized(path: str, index: int) -> dict:
    """One mesh of a `.serialized` file (format 3): positions, normals,
    uvs (float32) and faces (int64)."""
    raw = open(path, "rb").read()
    (count,) = struct.unpack_from("<I", raw, len(raw) - 4)
    offsets = list(struct.unpack_from(f"<{count}I", raw, len(raw) - 4 - 4 * count)) + [len(raw) - 4 - 4 * count]
    data = zlib.decompress(raw[offsets[index] + 4:offsets[index + 1]])
    flags, nv, nf = struct.unpack_from("<IQQ", data, 0)
    if not flags & 0x1000:
        raise ValueError("the reference reads single-precision meshes only")
    at = 20
    out = {}
    for key, width, flag in (("positions", 3, None), ("normals", 3, 0x1), ("uvs", 2, 0x2)):
        if flag is None or flags & flag:
            out[key] = np.frombuffer(data, "<f4", nv * width, at).reshape(nv, width).astype(np.float32)
            at += 4 * nv * width
    out["faces"] = np.frombuffer(data, "<u4", 3 * nf, at).reshape(nf, 3).astype(np.int64)
    return out


def _zip_unpredict(buf: bytes) -> bytes:
    """OpenEXR's ZIP pre-pass undone: running sums of byte deltas, then the
    two halves interleaved."""
    d = np.frombuffer(buf, np.uint8).astype(np.int64)
    d = (np.cumsum(d - np.r_[0, 128 * np.ones(len(d) - 1, np.int64)]) % 256).astype(np.uint8)
    half = (len(d) + 1) // 2
    out = np.empty_like(d)
    out[0::2], out[1::2] = d[:half], d[half:]
    return out.tobytes()


def read_exr(path: str) -> np.ndarray:
    """(H, W, 3) float32 of a scanline, half-float R, G, B, ZIP EXR."""
    raw = open(path, "rb").read()
    at, attrs = 8, {}
    while raw[at] != 0:
        name_end = raw.index(b"\0", at)
        type_end = raw.index(b"\0", name_end + 1)
        (size,) = struct.unpack_from("<i", raw, type_end + 1)
        attrs[raw[at:name_end].decode()] = raw[type_end + 5:type_end + 5 + size]
        at = type_end + 5 + size
    at += 1
    if attrs["compression"][0] != 3:
        raise ValueError("the reference reads ZIP EXR files only")
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    names, p = [], attrs["channels"]
    while p[0] != 0:
        end = p.index(b"\0")
        names.append(p[:end].decode())
        if struct.unpack_from("<i", p, end + 1)[0] != 1:
            raise ValueError("the reference reads half-float channels only")
        p = p[end + 17:]
    n_chunks = -(-h // 16)
    offsets = struct.unpack_from(f"<{n_chunks}Q", raw, at)
    img = np.zeros((h, w, len(names)), np.float32)
    for off in offsets:
        y, size = struct.unpack_from("<ii", raw, off)
        data = raw[off + 8:off + 8 + size]
        n = min(16, y1 + 1 - y)
        if size < n * w * len(names) * 2:
            data = _zip_unpredict(zlib.decompress(data))
        block = np.frombuffer(data, "<f2").reshape(n, len(names), w).astype(np.float32)
        img[y - y0:y - y0 + n] = block.transpose(0, 2, 1)
    return np.stack([img[..., names.index(c)] for c in "RGB"], axis=-1)


_TF_DTYPES = {1: np.uint8, 2: np.int8, 3: np.uint16, 4: np.int16, 5: np.uint32, 6: np.int32, 7: np.uint64,
              8: np.int64, 9: np.float16, 10: np.float32, 11: np.float64}


def read_tensor_file(path: str) -> dict:
    """The fields of an RGL tensor file (version 1.0), as numpy arrays."""
    raw = open(path, "rb").read()
    if raw[:12] != b"tensor_file\0":
        raise ValueError(f"{path}: not a tensor file")
    (n,) = struct.unpack_from("<I", raw, 14)
    at, out = 18, {}
    for _ in range(n):
        (nl,) = struct.unpack_from("<H", raw, at)
        name = raw[at + 2:at + 2 + nl].decode()
        at += 2 + nl
        ndim, code, off = struct.unpack_from("<HBQ", raw, at)
        shape = struct.unpack_from(f"<{ndim}Q", raw, at + 11)
        at += 11 + 8 * ndim
        dt = np.dtype(_TF_DTYPES[code]).newbyteorder("<")
        out[name] = np.frombuffer(raw, dt, int(np.prod(shape)) if shape else 1, off).reshape(shape)
    return out
