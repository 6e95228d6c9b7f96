"""RGL tensor-file reader and writer (the Dupuy & Jakob measured-BSDF
container), counterpart of the JAX package's `bsdf/tensorfile.py`:

    bytes 0..11   magic  b"tensor_file\\0"
    u8 x 2        version (1, 0)
    u32           field count
    per field:    u16 name_len | name | u16 ndim | u8 dtype
                  | u64 byte offset | u64 x ndim shape

Pure numpy, host-side.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict

import numpy as np

_MAGIC = b"tensor_file\x00"

_DTYPES = {
    1: np.uint8,
    2: np.int8,
    3: np.uint16,
    4: np.int16,
    5: np.uint32,
    6: np.int32,
    7: np.uint64,
    8: np.int64,
    9: np.float16,
    10: np.float32,
    11: np.float64,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclass(frozen=True)
class TensorFile:
    fields: Dict[str, np.ndarray]

    def __getitem__(self, name: str) -> np.ndarray:
        return self.fields[name]

    def __contains__(self, name: str) -> bool:
        return name in self.fields


def read_tensor_file(path: str) -> TensorFile:
    with open(path, "rb") as f:
        raw = f.read()
    if raw[: len(_MAGIC)] != _MAGIC:
        raise ValueError(f"{path}: not a tensor_file (bad magic)")
    off = len(_MAGIC)
    ver_major, ver_minor = struct.unpack_from("BB", raw, off)
    off += 2
    if ver_major != 1:
        raise ValueError(f"{path}: unsupported tensor_file version {ver_major}.{ver_minor}")
    (n_fields,) = struct.unpack_from("<I", raw, off)
    off += 4
    fields: Dict[str, np.ndarray] = {}
    for _ in range(n_fields):
        (name_len,) = struct.unpack_from("<H", raw, off)
        off += 2
        name = raw[off: off + name_len].decode("ascii")
        off += name_len
        ndim, dtype_code, data_offset = struct.unpack_from("<HBQ", raw, off)
        off += 11
        shape = struct.unpack_from(f"<{ndim}Q", raw, off)
        off += 8 * ndim
        dtype = _DTYPES.get(dtype_code)
        if dtype is None:
            raise ValueError(f"{path}: field {name!r} has unknown dtype {dtype_code}")
        count = int(np.prod(shape)) if shape else 1
        arr = np.frombuffer(raw, dtype=dtype, count=count, offset=data_offset)
        fields[name] = arr.reshape(shape)
    return TensorFile(fields)


def write_tensor_file(path: str, fields: Dict[str, np.ndarray]) -> None:
    """Write `fields` (name -> array of a tensor-file dtype) as a version
    1.0 tensor file; each field's data is 8-byte aligned."""
    arrays = {k: np.ascontiguousarray(v) for k, v in fields.items()}
    head = len(_MAGIC) + 6 + sum(2 + len(k) + 11 + 8 * a.ndim for k, a in arrays.items())
    entries, blobs, pos = [], [], -(-head // 8) * 8
    for k, a in arrays.items():
        code = _CODES.get(a.dtype.newbyteorder("="))
        if code is None:
            raise ValueError(f"field {k!r}: dtype {a.dtype} has no tensor-file code")
        entries.append(struct.pack("<H", len(k)) + k.encode("ascii") + struct.pack("<HBQ", a.ndim, code, pos)
                       + struct.pack(f"<{a.ndim}Q", *a.shape))
        data = a.astype(a.dtype.newbyteorder("<")).tobytes()
        pad = -len(data) % 8
        blobs.append(data + b"\0" * pad)
        pos += len(data) + pad
    out = _MAGIC + struct.pack("<BBI", 1, 0, len(arrays)) + b"".join(entries)
    out += b"\0" * (-len(out) % 8)
    with open(path, "wb") as f:
        f.write(out + b"".join(blobs))
