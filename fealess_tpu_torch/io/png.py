"""A small PNG reader on the standard library and numpy.

The port has no image library on the card, so the fixture's PNGs (8-bit
RGB colour, 16-bit gray depth) are decoded here: chunks are walked with
``struct``, the IDAT stream is inflated with ``zlib`` and each scanline is
un-filtered.  Returns what ``cv2.imread(path, cv2.IMREAD_UNCHANGED)``
returns for the covered formats: (H, W) for gray, (H, W, 3) in BGR order
for RGB, u8 or u16.

Covered: bit depth 8 or 16, colour type 0 (gray) or 2 (RGB),
non-interlaced, all five filter types.  None and Sub rows are
independent of the row above, so they are un-filtered for the whole image
at once (Sub is a per-byte-lane cumulative sum mod 256); Up, Average and
Paeth rows run in order, Average and Paeth one pixel at a time.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3}


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """(h, 1 + stride) filtered scanlines -> (h, stride) u8 bytes."""
    ftype = raw[:, 0]
    rows = raw[:, 1:]
    if (ftype > 4).any():
        raise ValueError(f"bad PNG filter type {int(ftype.max())}")
    out = np.empty((h, stride), np.uint8)
    none = ftype == 0
    out[none] = rows[none]
    sub = ftype == 1
    if sub.any():
        lanes = rows[sub].reshape(-1, stride // bpp, bpp)
        out[sub] = np.cumsum(lanes, axis=1, dtype=np.uint8).reshape(-1, stride)
    for r in np.nonzero(ftype >= 2)[0]:
        up = out[r - 1] if r > 0 else np.zeros(stride, np.uint8)
        if ftype[r] == 2:
            out[r] = rows[r] + up
            continue
        cur = rows[r].tolist()
        above = up.tolist()
        for i in range(stride):
            a = cur[i - bpp] if i >= bpp else 0
            if ftype[r] == 3:
                cur[i] = (cur[i] + ((a + above[i]) >> 1)) & 255
            else:
                c = above[i - bpp] if i >= bpp else 0
                cur[i] = (cur[i] + _paeth(a, above[i], c)) & 255
        out[r] = cur
    return out


def read_png(path: str) -> np.ndarray:
    """Decode a PNG file to u8/u16 (H, W) gray or (H, W, 3) BGR."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path} is not a PNG file")
    header = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path} has no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth not in (8, 16) or color not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, "
                         f"colour type {color}, interlace {interlace})")
    ch = _CHANNELS[color]
    bpp = ch * depth // 8
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: image data has {raw.size} bytes, "
                         f"expected {h * (stride + 1)}")
    pix = _unfilter(raw.reshape(h, stride + 1), h, stride, bpp)
    if depth == 16:
        img = pix.view(">u2").astype(np.uint16)
    else:
        img = pix
    img = img.reshape(h, w, ch)
    if ch == 1:
        return img[:, :, 0].copy()
    return img[:, :, ::-1].copy()          # RGB -> BGR
