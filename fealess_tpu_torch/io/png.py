"""A small PNG reader and writer on the standard library and numpy.

The port has no image library on the card, so PNGs are decoded here:
chunks are walked with ``struct``, the IDAT stream is inflated with
``zlib`` and each scanline is un-filtered.  Each reader returns what one
``cv2.imread`` flag returns for the covered files (OpenCV's libpng path,
without gamma chunks):

- :func:`read_png` (``IMREAD_UNCHANGED``): gray (H, W); RGB as BGR
  (H, W, 3); RGBA as BGRA (H, W, 4); gray+alpha as (g, g, g, a)
  (H, W, 4); palette as BGR (black for an index past the ``PLTE``
  entries), or BGRA when a ``tRNS`` chunk gives alpha (255 past its end);
  RGB with a ``tRNS`` colour as BGRA, alpha 0 on that colour and full
  elsewhere.  Gray ignores ``tRNS``; gray and RGB ignore ``PLTE``; a
  ``tRNS`` of the wrong length (empty or longer than the palette, not 6
  bytes for RGB) is ignored, as libpng does.  u16 at bit depth 16,
  else u8; gray at 1, 2 and 4 bits is scaled to 0..255.
- ``read_png(path, color=True)`` (``IMREAD_COLOR``): u8 BGR (H, W, 3):
  alpha dropped (not composited), gray replicated, 16-bit samples cut to
  their high byte (libpng's strip-16).
- :func:`read_png_gray` (``IMREAD_GRAYSCALE``): u8 (H, W): alpha dropped,
  colour to gray with libpng's ``png_set_rgb_to_gray(0.299, 0.587)``
  fixed-point weights (9797, 19234, 3737) / 32768, truncated at 8 bits
  and rounded at 16 bits before the cut to the high byte.

Covered: every colour type (0, 2, 3, 4, 6) at every bit depth PNG
allows, all five filter types.  Adam7-interlaced files, which cv2 reads,
raise :class:`UnsupportedPNG`.  None and Sub rows are independent of the
row above, so they are un-filtered for the whole image at once (Sub is a
per-byte-lane cumulative sum mod 256); Up, Average and Paeth rows run in
order, Average and Paeth one pixel at a time.  A file that does not
decode (where ``cv2.imread`` returns None) raises :class:`DecodeError`.

:func:`write_png` is the inverse for what ``cv2.imwrite`` writes on the
training path (u8 BGR colour, u8 or u16 gray), with filter type 0.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (samples a pixel, allowed bit depths)
_FORMATS = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
            4: (2, (8, 16)), 6: (4, (8, 16))}
# png_set_rgb_to_gray(png_ptr, 1, 0.299, 0.587) as libpng stores it
_GRAY_R, _GRAY_G = 9797, 19234
_GRAY_B = 32768 - _GRAY_R - _GRAY_G


class DecodeError(ValueError):
    """A file that does not decode: not a PNG, truncated or corrupt.
    ``cv2.imread`` returns None for it, so a frame loader skips it."""


class UnsupportedPNG(ValueError):
    """A valid PNG that this reader does not cover (Adam7 interlace).
    ``cv2.imread`` reads it, so no caller may skip it as undecodable: it is
    not a :class:`DecodeError`."""


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
        raise DecodeError(f"bad PNG filter type {int(ftype.max())}")
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


def read_png(path: str, color: bool = False) -> np.ndarray:
    """Decode a PNG file as ``cv2.imread(path, IMREAD_UNCHANGED)`` does;
    with ``color``, as ``IMREAD_COLOR`` does (see the module docstring)."""
    img, alpha = _decode(path)
    if not color:
        if img.shape[2] == 2:                          # gray + alpha
            img = img[:, :, [0, 0, 0, 1]]
        elif img.shape[2] >= 3:
            img = img[:, :, [2, 1, 0, 3][:img.shape[2]]]   # RGB(A) -> BGR(A)
        elif alpha is None:
            return img[:, :, 0].copy()
        if alpha is not None:
            img = np.concatenate([img, alpha[:, :, None]], axis=2)
        return np.ascontiguousarray(img)
    img = _strip16(img[:, :, :3 if img.shape[2] >= 3 else 1])
    if img.shape[2] == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[:, :, ::-1])


def read_png_gray(path: str) -> np.ndarray:
    """Decode a PNG file to u8 (H, W) as ``cv2.imread(path,
    IMREAD_GRAYSCALE)`` does (see the module docstring)."""
    img, _ = _decode(path)
    if img.shape[2] <= 2:
        return _strip16(img[:, :, :1])[:, :, 0].copy()
    rgb = img[:, :, :3].astype(np.int64)
    dot = _GRAY_R * rgb[:, :, 0] + _GRAY_G * rgb[:, :, 1] + _GRAY_B * rgb[:, :, 2]
    if img.dtype == np.uint16:
        return (((dot + 16384) >> 15) >> 8).astype(np.uint8)
    return (dot >> 15).astype(np.uint8)


def _strip16(img: np.ndarray) -> np.ndarray:
    return (img >> 8).astype(np.uint8) if img.dtype == np.uint16 else img


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """Encode u8 (H, W, 3) BGR as 8-bit RGB, or u8/u16 (H, W) as gray."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8:
        pix, color, depth = img[:, :, ::-1], 2, 8
    elif img.ndim == 2 and img.dtype in (np.uint8, np.uint16):
        pix, color, depth = img, 0, img.dtype.itemsize * 8
    else:
        raise ValueError(f"write_png: unsupported image {img.dtype}"
                         f"{img.shape}; expected u8 (H, W, 3) or u8/u16 "
                         f"(H, W)")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(pix, ">u2" if depth == 16 else np.uint8)
    rows = rows.view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)
    data = (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)


def _decode(path: str):
    """(samples (H, W, ch) u8/u16 in the file's order: G, GA, RGB, RGBA;
    alpha (H, W) from a ``tRNS`` chunk of a palette or RGB image, or
    None).  Palettes are expanded to RGB, gray below 8 bits scaled to
    0..255."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise DecodeError(f"{path} is not a PNG file")
    try:
        return _decode_chunks(path, data)
    except (DecodeError, UnsupportedPNG):
        raise
    except (ValueError, zlib.error, struct.error, IndexError) as e:
        raise DecodeError(f"{path}: {e}") from e


def _decode_chunks(path: str, data: bytes):
    header = plte = trns = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = body
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise DecodeError(f"{path} has no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if color not in _FORMATS or depth not in _FORMATS[color][1]:
        raise DecodeError(f"{path}: not a PNG bit depth {depth} with colour "
                          f"type {color}")
    if interlace != 0:
        raise UnsupportedPNG(f"{path}: interlaced PNGs are not supported")
    if color == 3:
        if plte is None or not 0 < len(plte) <= 768 or len(plte) % 3:
            raise DecodeError(f"{path}: palette image without a valid PLTE")
        # libpng keeps 2**depth entries of the chunk and 256 in all, those
        # past the palette black
        n_pal = min(len(plte) // 3, 1 << depth)
        pal = np.zeros((256, 3), np.uint8)
        pal[:n_pal] = np.frombuffer(plte, np.uint8).reshape(-1, 3)[:n_pal]
    ch = _FORMATS[color][0]
    bpp = max(1, ch * depth // 8)
    stride = (w * ch * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise DecodeError(f"{path}: image data has {raw.size} bytes, "
                          f"expected {h * (stride + 1)}")
    pix = _unfilter(raw.reshape(h, stride + 1), h, stride, bpp)
    if depth == 16:
        img = pix.view(">u2").astype(np.uint16).reshape(h, w, ch)
    elif depth == 8:
        img = pix.reshape(h, w, ch)
    else:
        bits = np.unpackbits(pix, axis=1)[:, :w * depth].reshape(h, w, depth)
        img = (bits @ (1 << np.arange(depth - 1, -1, -1))).astype(np.uint8)
        img = img[:, :, None]
        if color == 0:
            img = img * np.uint8(255 // ((1 << depth) - 1))
    alpha = None
    if color == 3:
        idx = img[:, :, 0]
        if trns is not None and 0 < len(trns) <= n_pal:
            table = np.full(256, 255, np.uint8)
            table[:len(trns)] = np.frombuffer(trns, np.uint8)
            alpha = table[idx]
        img = pal[idx]
    elif color == 2 and trns is not None and len(trns) == 6:
        key = np.asarray(struct.unpack(">HHH", trns), np.uint16)
        top = 65535 if depth == 16 else 255
        alpha = np.where((img == key).all(axis=2), 0, top).astype(img.dtype)
    return img, alpha
