"""EXR image IO: `read_exr(path) -> (H, W, 3) float32` and
`write_exr(path, img)`, counterpart of the JAX package's `native/exr.py`.

Scanline files without compression, with zlib compression (NONE, ZIPS,
ZIP) or with PIZ (Huffman + Haar wavelet, what the JAX package's OpenEXR
writer and the matpreview envmap use) are read in Python (numpy + zlib), so
no OpenEXR library is needed; other compressions raise
`NotImplementedError`. The PIZ decoder follows OpenEXR's `ImfPizCompressor`,
`ImfHuf` and `ImfWav`. `write_exr` writes half-float R, G, B with ZIP
compression.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = 20000630
_NONE, _ZIPS, _ZIP, _PIZ = 0, 2, 3, 4
_LINES = {_NONE: 1, _ZIPS: 1, _ZIP: 16, _PIZ: 32}  # scanlines per chunk
_PIXEL = {0: np.dtype("<u4"), 1: np.dtype("<f2"), 2: np.dtype("<f4")}  # UINT, HALF, FLOAT


def _unpredict(buf: bytes) -> bytes:
    """Undo the ZIP pre-pass: delta decoding, then re-interleave the two
    byte halves."""
    d = np.frombuffer(buf, np.uint8).astype(np.int64)
    d[1:] -= 128
    t = (np.cumsum(d) & 0xFF).astype(np.uint8)
    out = np.empty_like(t)
    half = (len(t) + 1) // 2
    out[0::2], out[1::2] = t[:half], t[half:]
    return out.tobytes()


def _predict(buf: bytes) -> bytes:
    b = np.frombuffer(buf, np.uint8)
    t = np.concatenate([b[0::2], b[1::2]]).astype(np.int64)
    d = t.copy()
    d[1:] = (t[1:] - t[:-1] + 128) & 0xFF
    return d.astype(np.uint8).tobytes()


def _huf_decode(buf: bytes, n_out: int) -> np.ndarray:
    """OpenEXR's Huffman stream -> n_out uint16 symbols. The header holds
    the smallest and largest symbol (the largest is the run-length code)
    and the stream's bit count; then come the code lengths (6 bits each,
    with zero runs), and the canonical codes, read MSB first."""
    im, i_max, _, n_bits = struct.unpack_from("<IIII", buf, 0)
    c = lc = 0
    p = 20

    def bits(n):
        nonlocal c, lc, p
        while lc < n:
            c = ((c & ((1 << lc) - 1)) << 8) | buf[p]
            p += 1
            lc += 8
        lc -= n
        return (c >> lc) & ((1 << n) - 1)

    lengths = {}
    sym = im
    while sym <= i_max:
        n = bits(6)
        if n == 63:  # long zero run
            sym += bits(8) + 6
        elif n >= 59:  # short zero run
            sym += n - 57
        else:
            if n:
                lengths[sym] = n
            sym += 1
    count = [0] * 59
    for n in lengths.values():
        count[n] += 1
    first, code = [0] * 59, 0
    for n in range(58, 0, -1):  # canonical codes: longest first
        first[n], code = code, (code + count[n]) >> 1
    codes = {}
    for s in sorted(lengths):
        n = lengths[s]
        codes[s] = (first[n], n)
        first[n] += 1

    max_len = max(lengths.values())
    short = min(max_len, 16)
    t_sym, t_len = np.zeros(1 << short, np.int64), np.zeros(1 << short, np.int64)
    long_codes = {}
    for s, (cd, n) in codes.items():
        if n <= short:
            t_sym[cd << (short - n):(cd + 1) << (short - n)] = s
            t_len[cd << (short - n):(cd + 1) << (short - n)] = n
        else:
            long_codes[(n, cd)] = s
    t_sym, t_len = t_sym.tolist(), t_len.tolist()

    data = buf[p:p + (n_bits + 7) // 8]
    out = []
    c = lc = i = 0
    left = n_bits
    while left > 0:
        while lc < 64 and i < len(data):
            c = ((c & ((1 << lc) - 1)) << 8) | data[i]
            i += 1
            lc += 8
        pre = (c >> (lc - short) if lc >= short else c << (short - lc)) & ((1 << short) - 1)
        n = t_len[pre]
        s = t_sym[pre]
        if not n:
            n = next((k for k in range(short + 1, min(max_len, lc) + 1)
                      if (k, (c >> (lc - k)) & ((1 << k) - 1)) in long_codes), 0)
            if not n:
                raise IOError("EXR PIZ: invalid Huffman code")
            s = long_codes[(n, (c >> (lc - n)) & ((1 << n) - 1))]
        if n > left:
            raise IOError("EXR PIZ: Huffman stream ends inside a code")
        lc -= n
        left -= n
        if s == i_max:  # run: repeat the last symbol 8-bit-count times
            lc -= 8
            left -= 8
            out.extend(out[-1:] * ((c >> lc) & 0xFF))
        else:
            out.append(s)
    if len(out) != n_out:
        raise IOError(f"EXR PIZ: {len(out)} symbols decoded, {n_out} expected")
    return np.array(out, np.uint16)


def _wdec(l, h, w14: bool):
    """One inverse Haar step on uint16 pairs (l, h) -> (a, b): 14-bit
    signed when every value fits 14 bits, else modulo 2^16."""
    l, h = l.astype(np.int32), h.astype(np.int32)
    if w14:
        ls, hs = l - ((l & 0x8000) << 1), h - ((h & 0x8000) << 1)
        a = ls + (hs & 1) + (hs >> 1)
        return (a & 0xFFFF).astype(np.uint16), ((a - hs) & 0xFFFF).astype(np.uint16)
    b = (l - (h >> 1)) & 0xFFFF
    return ((h + b - 0x8000) & 0xFFFF).astype(np.uint16), b.astype(np.uint16)


def _wav2_decode(a: np.ndarray, max_value: int) -> None:
    """In place: undo the 2D Haar wavelet of an (ny, nx) uint16 view, level
    by level from the coarsest; the odd column and line of each level are
    1D steps."""
    ny, nx = a.shape
    w14 = max_value < (1 << 14)
    p = 1
    while p <= min(nx, ny):
        p <<= 1
    p2, p = p >> 1, p >> 2
    while p >= 1:
        rows, cols = np.arange(0, ny - p2 + 1, p2), np.arange(0, nx - p2 + 1, p2)
        r, c = np.ix_(rows, cols)
        i00, i10 = _wdec(a[r, c], a[r + p, c], w14)
        i01, i11 = _wdec(a[r, c + p], a[r + p, c + p], w14)
        a[r, c], a[r, c + p] = _wdec(i00, i01, w14)
        a[r + p, c], a[r + p, c + p] = _wdec(i10, i11, w14)
        if nx & p:
            cx = len(cols) * p2
            a[rows, cx], a[rows + p, cx] = _wdec(a[rows, cx], a[rows + p, cx], w14)
        if ny & p:
            ry = len(rows) * p2
            a[ry, cols], a[ry, cols + p] = _wdec(a[ry, cols], a[ry, cols + p], w14)
        p2, p = p, p >> 1


def _piz_decode(data: bytes, chans: list, w: int, n_lines: int) -> bytes:
    """One PIZ chunk -> its raw scanline bytes (per line, the channels in
    order). The chunk holds the bitmap of the 16-bit values used, the
    Huffman stream of their indices, wavelet-coded per channel plane."""
    lo, hi = struct.unpack_from("<HH", data, 0)
    p = 4
    bitmap = np.zeros(8192, np.uint8)
    if lo <= hi:
        bitmap[lo:hi + 1] = np.frombuffer(data, np.uint8, hi - lo + 1, p)
        p += hi - lo + 1
    used = np.unpackbits(bitmap, bitorder="little").astype(bool)
    used[0] = True
    lut = np.flatnonzero(used).astype(np.uint16)  # index -> value
    (length,) = struct.unpack_from("<i", data, p)
    sizes = [_PIXEL[t].itemsize // 2 for _, t in chans]  # uint16 words per sample
    buf = _huf_decode(data[p + 4:p + 4 + length], sum(sizes) * w * n_lines)
    planes, start = [], 0
    for s in sizes:
        plane = buf[start:start + s * w * n_lines].reshape(n_lines, w, s)
        for j in range(s):
            _wav2_decode(plane[:, :, j], len(lut) - 1)
        planes.append(lut[plane.reshape(n_lines, w * s)])
        start += s * w * n_lines
    return np.concatenate(planes, axis=1).astype("<u2").tobytes()


def _header(raw: bytes):
    magic, version = struct.unpack_from("<ii", raw, 0)
    if magic != _MAGIC:
        raise IOError("not an EXR file (bad magic)")
    if version & 0x1E00:  # tiled, long names, deep or multi-part
        raise NotImplementedError("only single-part scanline EXR files are read in Python")
    p, attrs = 8, {}
    while raw[p] != 0:
        name_end = raw.index(b"\0", p)
        type_end = raw.index(b"\0", name_end + 1)
        name, typ = raw[p:name_end].decode(), raw[name_end + 1:type_end].decode()
        (size,) = struct.unpack_from("<i", raw, type_end + 1)
        attrs[name] = (typ, raw[type_end + 5:type_end + 5 + size])
        p = type_end + 5 + size
    return attrs, p + 1


def _channels(value: bytes) -> list:
    out, p = [], 0
    while value[p] != 0:
        end = value.index(b"\0", p)
        (ptype,) = struct.unpack_from("<i", value, end + 1)
        xs, ys = struct.unpack_from("<ii", value, end + 9)
        if (xs, ys) != (1, 1):
            raise NotImplementedError("subsampled EXR channels")
        out.append((value[p:end].decode(), ptype))
        p = end + 17
    return out


def _read_python(raw: bytes, attrs: dict, p: int) -> np.ndarray:
    comp = attrs["compression"][1][0]
    chans = _channels(attrs["channels"][1])
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    lines = _LINES[comp]
    n_chunks = -(-h // lines)
    offsets = struct.unpack_from(f"<{n_chunks}Q", raw, p)
    planes = {name: np.empty((h, w), np.float32) for name, _ in chans}
    for off in offsets:
        y, size = struct.unpack_from("<ii", raw, off)
        data = raw[off + 8:off + 8 + size]
        n_lines = min(lines, y1 - y + 1)
        full = sum(_PIXEL[t].itemsize for _, t in chans) * w * n_lines
        if comp == _PIZ and size < full:
            data = _piz_decode(data, chans, w, n_lines)
        elif comp != _NONE and size < full:
            data = _unpredict(zlib.decompress(data))
        q = 0
        for line in range(n_lines):
            for name, t in chans:
                n_bytes = _PIXEL[t].itemsize * w
                planes[name][y - y0 + line] = np.frombuffer(data, _PIXEL[t], w, q)
                q += n_bytes
    return np.stack([planes["R"], planes["G"], planes["B"]], axis=-1)


def read_exr(path: str) -> np.ndarray:
    """(H, W, 3) float32, top-down row-major."""
    with open(path, "rb") as f:
        raw = f.read()
    attrs, p = _header(raw)
    comp = attrs["compression"][1][0]
    if comp not in _LINES:
        raise NotImplementedError(f"EXR compression {comp}: only NONE, ZIPS, ZIP and PIZ are read")
    return _read_python(raw, attrs, p)


def _attr(name: str, typ: str, value: bytes) -> bytes:
    return name.encode() + b"\0" + typ.encode() + b"\0" + struct.pack("<i", len(value)) + value


def write_exr(path: str, img: np.ndarray) -> None:
    """Half-float R, G, B scanline EXR with ZIP compression."""
    img = np.ascontiguousarray(img, np.float32)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3), got {img.shape}")
    h, w, _ = img.shape
    chlist = b"".join(c + b"\0" + struct.pack("<iB3xii", 1, 0, 1, 1) for c in (b"B", b"G", b"R")) + b"\0"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    head = struct.pack("<ii", _MAGIC, 2) + b"".join([
        _attr("channels", "chlist", chlist),
        _attr("compression", "compression", bytes([_ZIP])),
        _attr("dataWindow", "box2i", box),
        _attr("displayWindow", "box2i", box),
        _attr("lineOrder", "lineOrder", bytes([0])),
        _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
        _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0)),
        _attr("screenWindowWidth", "float", struct.pack("<f", 1.0)),
    ]) + b"\0"
    half = img.astype("<f2")
    lines = _LINES[_ZIP]
    chunks = []
    for y in range(0, h, lines):
        block = half[y:y + lines]  # (n, W, 3): per line B, G, R planes
        raw = np.ascontiguousarray(block[..., ::-1].transpose(0, 2, 1)).tobytes()
        packed = zlib.compress(_predict(raw))
        data = packed if len(packed) < len(raw) else raw
        chunks.append(struct.pack("<ii", y, len(data)) + data)
    table_end = len(head) + 8 * len(chunks)
    offsets, pos = [], table_end
    for c in chunks:
        offsets.append(pos)
        pos += len(c)
    with open(path, "wb") as f:
        f.write(head + struct.pack(f"<{len(offsets)}Q", *offsets) + b"".join(chunks))
