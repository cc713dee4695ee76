"""A small PNG reader and writer on the standard library and numpy.

The port has no image library on the card, so PNGs are decoded here:
chunks are walked with ``struct``, the IDAT stream is inflated with
``zlib`` and each scanline is un-filtered.  Each reader returns what one
``cv2.imread`` flag returns (OpenCV 5.0's libpng 1.6 path):

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
  colour to gray by libpng's ``png_do_rgb_to_gray`` with the weights of
  ``png_set_rgb_to_gray(0.299, 0.587)``, (9797, 19234, 3737) / 32768.
  Without a file gamma (or with one within 5% of 1.0, as libpng judges
  it) the weighted sum is truncated at 8 bits and rounded at 16 bits
  before the cut to the high byte.  With a ``gAMA`` or ``sRGB`` chunk
  (``sRGB`` means gamma 45455 and wins over ``gAMA``; the first valid
  ``gAMA`` counts; either is ignored after ``PLTE`` or ``IDAT``) non-gray
  pixels are summed in linear light: libpng's ``gamma_to_1`` table, the
  weights rounded, then ``gamma_from_1``; at 16 bits the tables are
  indexed by the sample's top 16 - shift bits (shift 5, or 16 - ``sBIT``
  up to 8) and gray pixels (r == g == b) go through the 16-to-8 table.
  Screen gamma is libpng's default (the file's reciprocal), as cv2 sets
  none.  Each table is built once per (gamma, shift) with libpng's
  floating-point formulas.

Covered: every colour type (0, 2, 3, 4, 6) at every bit depth PNG
allows, all five filter types, progressive and Adam7-interlaced.  The
scanlines are un-filtered in C (``csrc/png_unfilter.c``, built with the
host compiler at first use and called through ctypes, which releases the
interpreter lock; a failed build raises).  :func:`_unfilter_plain` is its
numpy twin, which the tests hold it to.  Each Adam7 pass is un-filtered
at its own stride and scattered to ``(y0::dy, x0::dx)``.  A file that
does not decode (where ``cv2.imread`` returns None) raises
:class:`DecodeError`.

:func:`write_png` is the inverse for what ``cv2.imwrite`` writes on the
training path (u8 BGR colour, u8 or u16 gray), with filter type 0.
"""

from __future__ import annotations

import ctypes
import functools
import struct
import threading
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (samples a pixel, allowed bit depths)
_FORMATS = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
            4: (2, (8, 16)), 6: (4, (8, 16))}
# png_set_rgb_to_gray(png_ptr, 1, 0.299, 0.587) as libpng stores it
_GRAY_R, _GRAY_G = 9797, 19234
_GRAY_B = 32768 - _GRAY_R - _GRAY_G
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_GAMMA_SRGB = 45455          # PNG_GAMMA_sRGB_INVERSE
_FP_1 = 100000               # libpng's fixed-point 1.0


class DecodeError(ValueError):
    """A file that does not decode: not a PNG, truncated or corrupt.
    ``cv2.imread`` returns None for it, so a frame loader skips it."""


def _chunks(data: bytes):
    """(kind, body, the stored CRC or None where the file ends first) of
    each chunk."""
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + length
        crc = (struct.unpack(">I", data[end:end + 4])[0]
               if end + 4 <= len(data) else None)
        yield kind, data[pos + 8:end], crc
        pos += 12 + length


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


_UNFILTER = None
_UNFILTER_LOCK = threading.Lock()


def _unfilter_fn():
    """``fl_png_unfilter`` of the host library (built at first use)."""
    global _UNFILTER
    with _UNFILTER_LOCK:
        if _UNFILTER is None:
            from fealess_tpu_torch.ops import _build
            fn = ctypes.CDLL(str(_build.build_host("png_unfilter"))
                             ).fl_png_unfilter
            fn.argtypes = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int)
            fn.restype = ctypes.c_int
            _UNFILTER = fn
    return _UNFILTER


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """(h, 1 + stride) filtered scanlines -> (h, stride) u8 bytes, in C."""
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.shape != (h, stride + 1):
        raise ValueError(f"scanlines {raw.shape}, expected {(h, stride + 1)}")
    out = np.empty((h, stride), np.uint8)
    bad = _unfilter_fn()(raw.ctypes.data, out.ctypes.data, h, stride, bpp)
    if bad:
        raise DecodeError(f"bad PNG filter type {int(raw[bad - 1, 0])}")
    return out


def _unfilter_plain(raw: np.ndarray, h: int, stride: int,
                    bpp: int) -> np.ndarray:
    """The numpy twin of :func:`_unfilter`: None and Sub rows for the
    whole image at once (Sub is a per-byte-lane cumulative sum mod 256),
    Up, Average and Paeth rows in order, Average and Paeth one byte at a
    time."""
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
    img, alpha, _ = _decode(path)
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
    img, _, (gamma, sbit) = _decode(path)
    if img.shape[2] <= 2:
        return _strip16(img[:, :, :1])[:, :, 0].copy()
    rgb = img[:, :, :3].astype(np.int64)
    r, g, b = rgb[:, :, 0], rgb[:, :, 1], rgb[:, :, 2]
    wide = img.dtype == np.uint16
    screen = _reciprocal(gamma) if gamma else 0
    if not gamma or not (_significant(gamma) or _significant(screen)):
        dot = _GRAY_R * r + _GRAY_G * g + _GRAY_B * b
        if wide:
            return (((dot + 16384) >> 15) >> 8).astype(np.uint8)
        return (dot >> 15).astype(np.uint8)
    # libpng's gamma tables (png_build_gamma_table) with the screen gamma
    # defaulted to the file's reciprocal: gamma_to_1 (exponent 1 / file
    # gamma, which is the screen gamma), gamma_from_1 and the overall table
    # for gray pixels
    to_1 = screen
    from_1 = _reciprocal(screen) if screen > 0 else gamma
    same = (r == g) & (r == b)
    if not wide:
        overall = _reciprocal2(gamma, screen) if screen > 0 else _FP_1
        t_to, t_from = _table8(to_1), _table8(from_1)
        dot = (_GRAY_R * t_to[r] + _GRAY_G * t_to[g] + _GRAY_B * t_to[b]
               + 16384) >> 15
        return np.where(same, _table8(overall)[r],
                        t_from[dot]).astype(np.uint8)
    # 16 bits, cut to 8 (PNG_16_TO_8): tables of the top 16 - shift bits
    shift = 16 - sbit if 0 < sbit < 16 else 0
    shift = min(max(shift, 5), 8)
    overall = _product2(gamma, screen) if screen > 0 else _FP_1
    t_to, t_from = _table16(shift, to_1), _table16(shift, from_1)
    dot = (_GRAY_R * t_to[r >> shift] + _GRAY_G * t_to[g >> shift]
           + _GRAY_B * t_to[b >> shift] + 16384) >> 15
    w = np.where(same, _table16to8(shift, overall)[r >> shift],
                 t_from[dot >> shift])
    return (w >> 8).astype(np.uint8)


def _strip16(img: np.ndarray) -> np.ndarray:
    return (img >> 8).astype(np.uint8) if img.dtype == np.uint16 else img


# libpng's fixed-point gamma arithmetic (png.c, floating-point build)
def _significant(g: int) -> bool:
    return g < _FP_1 - 5000 or g > _FP_1 + 5000


def _fixed(r: float) -> int:
    """A rounded fixed-point result, 0 where libpng's overflows int32."""
    r = np.floor(r + .5)
    return int(r) if r <= 2147483647 else 0


def _reciprocal(a: int) -> int:
    return _fixed(1e10 / a)


def _reciprocal2(a: int, b: int) -> int:
    return _fixed(1e15 / a / b)


def _product2(a: int, b: int) -> int:
    return _fixed(a * 1e-5 * b)


@functools.lru_cache(maxsize=None)
def _table8(g: int) -> np.ndarray:
    """png_build_8bit_table: v -> floor(255 (v/255)^(g/1e5) + .5)."""
    if not _significant(g):
        return np.arange(256)
    table = np.floor(255 * np.power(np.arange(256) / 255., g * 1e-5) + .5)
    table[[0, 255]] = (0, 255)
    return table.astype(np.int64)


@functools.lru_cache(maxsize=None)
def _table16(shift: int, g: int) -> np.ndarray:
    """png_build_16bit_table, flattened: index v >> shift."""
    top = (1 << (16 - shift)) - 1
    ig = np.arange(top + 1)
    if _significant(g):
        return np.floor(65535. * np.power(ig * (1.0 / top), g * 1e-5)
                        + .5).astype(np.int64)
    if shift:
        return (ig * 65535 + (1 << (15 - shift))) // top
    return ig


@functools.lru_cache(maxsize=None)
def _table16to8(shift: int, g: int) -> np.ndarray:
    """png_build_16to8_table, flattened: index v >> shift -> the 16-bit
    value i * 257 of the nearest 8-bit output i."""
    top = (1 << (16 - shift)) - 1
    table = np.full(top + 1, 65535, np.int64)
    last = 0
    for i in range(255):
        out = i * 257
        v = out + 128                 # png_gamma_16bit_correct(out + 128)
        bound = int(np.floor(65535 * np.power(v / 65535., g * 1e-5) + .5))
        bound = (bound * top + 32768) // 65535 + 1
        if last < bound:
            table[last:bound] = out
            last = bound
    return table


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
    None; (file gamma or None, the largest ``sBIT`` colour value or 0)).
    Palettes are expanded to RGB, gray below 8 bits scaled to 0..255."""
    with open(path, "rb") as f:
        return decode_bytes(f.read(), path)


def decode_bytes(data: bytes, what: str):
    """:func:`_decode` of a PNG file's bytes; ``what`` names it in
    errors."""
    if not data.startswith(_SIGNATURE):
        raise DecodeError(f"{what} is not a PNG file")
    try:
        return _decode_chunks(what, data)
    except DecodeError:
        raise
    except (ValueError, zlib.error, struct.error, IndexError) as e:
        raise DecodeError(f"{what}: {e}") from e


def _samples(pix: np.ndarray, h: int, w: int, ch: int,
             depth: int) -> np.ndarray:
    """(h, stride) un-filtered bytes -> (h, w, ch) samples, sub-byte
    depths unpacked (not scaled)."""
    if depth == 16:
        return pix.view(">u2").astype(np.uint16).reshape(h, w, ch)
    if depth == 8:
        return pix.reshape(h, w, ch)
    bits = np.unpackbits(pix, axis=1)[:, :w * depth].reshape(h, w, depth)
    return (bits @ (1 << np.arange(depth - 1, -1, -1))).astype(
        np.uint8)[:, :, None]


def _image_data(path: str, raw: np.ndarray, w: int, h: int, ch: int,
                depth: int, interlace: int) -> np.ndarray:
    """The inflated IDAT stream -> (h, w, ch) samples: one pass, or the
    seven Adam7 passes, each un-filtered at its own stride (an empty pass
    has no rows) and scattered to ``(y0::dy, x0::dx)``."""
    bpp = max(1, ch * depth // 8)
    passes = [(0, 0, 1, 1)] if interlace == 0 else _ADAM7
    sizes = [((h - y0 + dy - 1) // dy, (w - x0 + dx - 1) // dx)
             for x0, y0, dx, dy in passes]
    sizes = [(ph, pw) if ph > 0 and pw > 0 else (0, 0) for ph, pw in sizes]
    strides = [(pw * ch * depth + 7) // 8 for _, pw in sizes]
    expected = sum(ph * (st + 1) for (ph, _), st in zip(sizes, strides))
    if raw.size != expected:
        raise DecodeError(f"{path}: image data has {raw.size} bytes, "
                          f"expected {expected}")
    if interlace == 0:
        return _samples(_unfilter(raw.reshape(h, strides[0] + 1), h,
                                  strides[0], bpp), h, w, ch, depth)
    img = np.empty((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for (x0, y0, dx, dy), (ph, pw), st in zip(passes, sizes, strides):
        if ph == 0:
            continue
        n = ph * (st + 1)
        pix = _unfilter(raw[pos:pos + n].reshape(ph, st + 1), ph, st, bpp)
        img[y0::dy, x0::dx] = _samples(pix, ph, pw, ch, depth)
        pos += n
    return img


def _gamma_chunks(kind: bytes, body: bytes, color: int, depth: int,
                  found: dict) -> None:
    """Record a ``gAMA``, ``sRGB`` or ``sBIT`` chunk seen before ``PLTE``
    and ``IDAT`` as libpng 1.6 keeps it: the first valid one of each kind
    (``gAMA``: 4 bytes, 0 < value < 2**31; ``sRGB``: 1 byte, intent 0..3;
    ``sBIT``: one byte a channel, each 1..the sample depth)."""
    if kind in found:
        return
    if kind == b"gAMA" and len(body) == 4:
        value = struct.unpack(">I", body)[0]
        if 0 < value < 2 ** 31:
            found[kind] = value
    elif kind == b"sRGB" and len(body) == 1 and body[0] <= 3:
        found[kind] = _GAMMA_SRGB
    elif kind == b"sBIT":
        n = 3 if color == 3 else _FORMATS[color][0]
        top = 8 if color == 3 else depth
        if len(body) == n and all(0 < v <= top for v in body):
            found[kind] = max(body[:3])


def _decode_chunks(path: str, data: bytes):
    header = plte = trns = None
    idat = []
    found = {}
    for kind, body, _ in _chunks(data):
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
        elif (kind in (b"gAMA", b"sRGB", b"sBIT") and header is not None
              and plte is None and not idat):
            _gamma_chunks(kind, body, header[3], header[2], found)
    if header is None:
        raise DecodeError(f"{path} has no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if color not in _FORMATS or depth not in _FORMATS[color][1]:
        raise DecodeError(f"{path}: not a PNG bit depth {depth} with colour "
                          f"type {color}")
    if interlace not in (0, 1):
        raise DecodeError(f"{path}: unknown interlace method {interlace}")
    if color == 3:
        if plte is None or not 0 < len(plte) <= 768 or len(plte) % 3:
            raise DecodeError(f"{path}: palette image without a valid PLTE")
        # libpng keeps 2**depth entries of the chunk and 256 in all, those
        # past the palette black
        n_pal = min(len(plte) // 3, 1 << depth)
        pal = np.zeros((256, 3), np.uint8)
        pal[:n_pal] = np.frombuffer(plte, np.uint8).reshape(-1, 3)[:n_pal]
    ch = _FORMATS[color][0]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = _image_data(path, raw, w, h, ch, depth, interlace)
    if depth < 8 and color == 0:
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
    gamma = found.get(b"sRGB", found.get(b"gAMA"))
    return img, alpha, (gamma, found.get(b"sBIT", 0))
