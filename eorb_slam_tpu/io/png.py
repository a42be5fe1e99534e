"""PNG reader and writer on ``zlib`` and numpy.

Covers what the dataset layouts store: 8-bit greyscale frames (EuRoC,
EV-ETHZ) and 16-bit greyscale depth (TUM RGB-D). The reader also takes
8/16-bit grey+alpha, RGB and RGBA (colour is reduced to luma the way image
libraries convert to "L"), and all five row filter types. Interlaced and
palette images are refused with an error.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}     # colour type -> samples per pixel


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """Write an (H,W) uint8 or uint16 array as a greyscale PNG."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"expected (H,W) uint8/uint16, got {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape
    depth = 8 * img.dtype.itemsize
    rows = img.astype(img.dtype.newbyteorder(">")).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          rows.reshape(h, -1)], axis=1)   # filter 0 per row
    with open(path, "wb") as f:
        f.write(_SIG)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, 0, 0,
                                            0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(data: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (PNG spec §9). Returns (h, stride) uint8."""
    data = data.reshape(h, stride + 1)
    ftypes = data[:, 0]
    lines = data[:, 1:].astype(np.int32)
    if np.any(ftypes > 4):
        raise ValueError(f"bad PNG filter type {int(ftypes.max())}")
    if np.all(ftypes <= 2):
        # None / Sub / Up: Sub is a running sum along each of the bpp lanes
        out = np.empty_like(lines)
        prev = np.zeros(stride, np.int32)
        for r in range(h):
            cur = lines[r]
            if ftypes[r] == 1:
                cur = np.cumsum(cur.reshape(-1, bpp), axis=0).reshape(-1)
            elif ftypes[r] == 2:
                cur = cur + prev
            prev = out[r] = cur & 0xFF
        return out.astype(np.uint8)
    # Average and Paeth depend on the reconstructed left, up and up-left
    # bytes: sweep anti-diagonals of (row, pixel), all rows at once
    n = stride // bpp
    raw = lines.reshape(h, n, bpp)
    out = np.zeros((h + 1, n + 1, bpp), np.int32)   # zero row/col border
    ft = ftypes.astype(np.int32)
    for d in range(h + n - 1):
        r = np.arange(max(0, d - n + 1), min(h - 1, d) + 1)
        c = d - r
        left, up, ul = out[r + 1, c], out[r, c + 1], out[r, c]
        f = ft[r][:, None]
        pred = np.select(
            [f == 1, f == 2, f == 3, f == 4],
            [left, up, (left + up) >> 1, _paeth(left, up, ul)], 0)
        out[r + 1, c + 1] = (raw[r, c] + pred) & 0xFF
    return out[1:, 1:].reshape(h, stride).astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """Read a PNG as (H,W) uint8 or uint16 greyscale."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(buf):
        (n,) = struct.unpack(">I", buf[pos:pos + 4])
        tag, data = buf[pos + 4:pos + 8], buf[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: missing IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if ctype not in _CHANNELS or depth not in (8, 16) or interlace:
        raise ValueError(f"{path}: unsupported PNG (colour type {ctype}, "
                         f"bit depth {depth}, interlace {interlace})")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    px = _unfilter(raw, h, w * bpp, bpp)
    if depth == 16:
        px = px.view(">u2").astype(np.uint16)
    px = px.reshape(h, w, ch)
    if ch >= 3:   # ITU-R 601-2 luma, rounded as image libraries do for "L"
        p = px[..., :3].astype(np.uint64)
        grey = (p[..., 0] * 19595 + p[..., 1] * 38470 + p[..., 2] * 7471
                + 0x8000) >> 16
        return grey.astype(px.dtype)
    return px[..., 0]
