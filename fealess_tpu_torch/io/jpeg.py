"""A JPEG reader: the counterpart of ``cv2.imread`` on a JPEG file
(OpenCV's libjpeg-turbo path), bit for bit.

The card has no image library, so JPEG files are decoded here, on the
host, in C (``csrc/jpeg_decode.c``: libjpeg-turbo's Huffman decoding,
``jpeg_idct_islow``, fancy upsampling and fixed-point colour conversion;
built with the host compiler at first use and called through ctypes,
which releases the interpreter lock, so a frame loader's threads decode
in parallel; a failed build raises, and there is no Python fallback).

Read: baseline, extended (8-bit) and progressive Huffman files, gray or
three components (YCbCr, or RGB by the Adobe marker or the component
ids), every integral sampling factor (cv2 writes 4:4:4, 4:2:2, 4:2:0,
4:4:0 and 4:1:1), restart intervals, and entropy data that ends early
(the missing blocks decode as zero coefficients, as libjpeg leaves them).
:func:`decode_jpeg` returns what one ``cv2.imread`` flag returns:

- ``IMREAD_COLOR``: u8 BGR (H, W, 3), a gray file replicated;
- ``IMREAD_GRAYSCALE``: u8 (H, W): libjpeg's gray output, which is Y
  itself for a YCbCr file (not BGR2GRAY of the colour image);
- ``IMREAD_UNCHANGED``: gray (H, W) or BGR (H, W, 3), never rotated.

Under COLOR and GRAYSCALE the EXIF orientation of the file's first Exif
APP1 segment (tag 0x0112, orientations 2-8) is applied as cv2 applies it.

A file libjpeg fails on (where ``cv2.imread`` returns None) raises
:class:`~fealess_tpu_torch.io.png.DecodeError`.  A kind cv2 reads and
this decoder does not (arithmetic coding, lossless, hierarchical, 12-bit
samples, four components, tables left to libjpeg's defaults, a
progressive file libjpeg would block-smooth) raises
:class:`UnsupportedImage`, on which no caller skips a frame.
"""

from __future__ import annotations

import ctypes
import struct
import threading

import numpy as np

from fealess_tpu_torch.io.png import DecodeError

# cv2's flag values
IMREAD_UNCHANGED, IMREAD_GRAYSCALE, IMREAD_COLOR = -1, 0, 1

SIGNATURE = b"\xff\xd8\xff"

# fl_jpeg_* return codes above 0: kinds cv2 reads and this decoder does not
_UNSUPPORTED = {
    1: "arithmetic-coded JPEG",
    2: "lossless JPEG (SOF3)",
    3: "hierarchical JPEG",
    4: "JPEG with 12- or 16-bit samples",
    5: "four-component (CMYK/YCCK) JPEG",
    6: "progressive JPEG with incomplete low-frequency coefficients "
       "(libjpeg block-smooths it)",
    7: "JPEG without Huffman tables (libjpeg's defaults)",
}
_BAD = {-1: "corrupt JPEG data", -2: "out of memory",
        -3: "no frame header", -4: "fractional sampling factors",
        -5: "bad Huffman or quantization table", -6: "bad scan header"}


# OpenCV's CV_IO_MAX_IMAGE_WIDTH / HEIGHT / PIXELS (validateInputImageSize)
MAX_SIDE, MAX_PIXELS = 1 << 20, 1 << 30


def check_size(w: int, h: int, path: str) -> None:
    """Raise ``ValueError`` (not :class:`DecodeError`: ``cv2.imread``
    raises ``cv2.error`` there, it does not return None) for a header
    whose size is past OpenCV's limits, before anything is allocated."""
    if not (w <= MAX_SIDE and h <= MAX_SIDE and w * h <= MAX_PIXELS):
        raise ValueError(f"{path}: image size {w}x{h} is past cv2.imread's "
                         f"limits")


class UnsupportedImage(ValueError):
    """A file cv2 decodes and the port does not: the message names the
    format.  No caller skips a frame on it, so a frame cv2 would serve is
    never dropped without a word."""


_LIB = None
_LIB_LOCK = threading.Lock()


def _lib():
    """The host library (built at first use)."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from fealess_tpu_torch.ops import _build
            lib = ctypes.CDLL(str(_build.build_host("jpeg_decode")))
            lib.fl_jpeg_header.argtypes = (ctypes.c_char_p, ctypes.c_long,
                                           ctypes.c_void_p)
            lib.fl_jpeg_decode.argtypes = (ctypes.c_char_p, ctypes.c_long,
                                           ctypes.c_int, ctypes.c_void_p)
            lib.fl_jpeg_header.restype = ctypes.c_int
            lib.fl_jpeg_decode.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def _check(rc: int, path: str) -> None:
    if rc > 0:
        raise UnsupportedImage(f"{path}: {_UNSUPPORTED[rc]} is read by "
                               f"cv2.imread but not by the port")
    if rc < 0:
        raise DecodeError(f"{path}: {_BAD.get(rc, 'corrupt JPEG')}")


def exif_orientation(data: bytes) -> int:
    """The orientation tag (0x0112) of the first APP1 segment before the
    first scan that starts ``Exif\\0\\0``, as OpenCV 5's ExifReader reads
    it (the TIFF header after those 6 bytes, the u16 at the entry's value
    field, whatever the type); 1 when there is none."""
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            return 1
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker == 0xDA or marker == 0xD9:
            return 1
        if 0xD0 <= marker <= 0xD8 or marker == 0x01:
            pos += 2
            continue
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if marker == 0xE1 and data[pos + 4:pos + 10] == b"Exif\0\0":
            return tiff_orientation(data[pos + 10:pos + 2 + length])
        pos += 2 + length
    return 1


def tiff_orientation(tiff: bytes) -> int:
    """Tag 0x0112 of the first IFD of a TIFF header (``II`` or ``MM``),
    or 1."""
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if tiff[:2] == b"II" else ">"
    if struct.unpack(e + "H", tiff[2:4])[0] != 0x2A:
        return 1
    ifd = struct.unpack(e + "I", tiff[4:8])[0]
    if ifd + 2 > len(tiff):
        return 1
    n = struct.unpack(e + "H", tiff[ifd:ifd + 2])[0]
    for i in range(n):
        at = ifd + 2 + 12 * i
        if at + 12 > len(tiff):
            return 1
        if struct.unpack(e + "H", tiff[at:at + 2])[0] == 0x0112:
            return struct.unpack(e + "H", tiff[at + 8:at + 10])[0]
    return 1


def orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's ExifTransform: orientations 2-8 as flips and transposes
    of the stored image (any other value leaves it)."""
    t = lambda a: a.swapaxes(0, 1)                       # noqa: E731
    ops = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1],
           4: lambda a: a[::-1], 5: t, 6: lambda a: t(a)[:, ::-1],
           7: lambda a: t(a[::-1, ::-1]), 8: lambda a: t(a)[::-1]}
    if orientation not in ops:
        return img
    return np.ascontiguousarray(ops[orientation](img))


def decode_jpeg(data: bytes, flag: int = IMREAD_COLOR,
                path: str = "<bytes>") -> np.ndarray:
    """Decode JPEG bytes as ``cv2.imread(path, flag)`` does (see the
    module docstring)."""
    lib = _lib()
    info = np.zeros(5, np.int32)
    _check(lib.fl_jpeg_header(data, len(data), info.ctypes.data), path)
    w, h, ncomp = int(info[0]), int(info[1]), int(info[2])
    check_size(w, h, path)
    gray = flag == IMREAD_GRAYSCALE or (flag == IMREAD_UNCHANGED
                                        and ncomp == 1)
    out = np.empty((h, w) if gray else (h, w, 3), np.uint8)
    _check(lib.fl_jpeg_decode(data, len(data), int(gray), out.ctypes.data),
           path)
    if flag == IMREAD_UNCHANGED:
        return out
    return orient(out, exif_orientation(data))

