"""Motion JPEG frames as ``cv2.VideoCapture`` returns them: FFmpeg's
``mjpeg`` decoder, then swscale to BGR24, bit for bit
(``csrc/mjpeg_decode.c``, host C built at first use and called through
ctypes; see that file for the stages).

This is not :mod:`fealess_tpu_torch.io.jpeg`: ``cv2.imread`` decodes the
same bytes with libjpeg-turbo, whose IDCT, chroma upsampling and colour
conversion differ from FFmpeg's at most pixels.

Read: baseline and progressive Huffman frames, gray, 4:2:0, 4:2:2 and
4:4:4 at any size (odd sizes take swscale's bicubic chroma filters, which
are reproduced), with or without their DHT segments (Annex K's tables
stand in), with restart intervals, full range (``yuvj*``) or, after a
``CS=ITU601`` comment, limited range.  A frame FFmpeg decodes and the
port does not raises :class:`~fealess_tpu_torch.io.jpeg.UnsupportedImage`,
naming it; a frame FFmpeg fails on raises
:class:`~fealess_tpu_torch.io.png.DecodeError`.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from fealess_tpu_torch.io.jpeg import (_BAD, _UNSUPPORTED, UnsupportedImage)
from fealess_tpu_torch.io.png import DecodeError

_MJPEG_UNSUPPORTED = {
    **{k: v for k, v in _UNSUPPORTED.items() if k != 6},
    7: "Motion JPEG sampling other than gray, 4:2:0, 4:2:2 and 4:4:4",
    8: "RGB Motion JPEG",
    9: "Motion JPEG frame whose entropy data ends early (FFmpeg conceals "
       "the missing blocks)",
}

_LIB = None
_LIB_LOCK = threading.Lock()


def _lib():
    """The host library (built at first use)."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from fealess_tpu_torch.ops import _build
            lib = ctypes.CDLL(str(_build.build_host("mjpeg_decode")))
            lib.fl_mjpeg_header.argtypes = (ctypes.c_char_p, ctypes.c_long,
                                            ctypes.c_void_p)
            lib.fl_mjpeg_decode.argtypes = (ctypes.c_char_p, ctypes.c_long,
                                            ctypes.c_int, ctypes.c_void_p)
            lib.fl_mjpeg_header.restype = ctypes.c_int
            lib.fl_mjpeg_decode.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def _check(rc: int, what: str) -> None:
    if rc > 0:
        raise UnsupportedImage(f"{what}: {_MJPEG_UNSUPPORTED[rc]} is read "
                               f"by cv2.VideoCapture but not by the port")
    if rc < 0:
        raise DecodeError(f"{what}: {_BAD.get(rc, 'corrupt JPEG')}")


def header(data: bytes, what: str = "<frame>"):
    """The frame's ``(width, height)``, from its SOF."""
    info = np.zeros(2, np.int32)
    _check(_lib().fl_mjpeg_header(data, len(data), info.ctypes.data), what)
    return int(info[0]), int(info[1])


def itu601_comment(data: bytes):
    """``(now, later)``: whether a COM segment reading ``CS=ITU601`` comes
    before the frame's SOF (FFmpeg picks the limited-range ``yuv*`` planes
    for this frame) or between its SOF and its first scan (from the next
    frame on).  FFmpeg's mjpeg decoder keeps the flag once it is set."""
    pos, sof = 2, False
    now = later = False
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker in (0xDA, 0xD9):
            break
        if 0xD0 <= marker <= 0xD8 or marker == 0x01:
            pos += 2
            continue
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            sof = True
        elif marker == 0xFE and data[pos + 4:pos + 2 + length].rstrip(
                b"\0") == b"CS=ITU601":
            if sof:
                later = True
            else:
                now = True
        pos += 2 + length
    return now, later


def decode_frame(data: bytes, full_range: bool = True,
                 what: str = "<frame>") -> np.ndarray:
    """One Motion JPEG frame as BGR u8 (H, W, 3)."""
    data = bytes(data)
    w, h = header(data, what)
    out = np.empty((h, w, 3), np.uint8)
    _check(_lib().fl_mjpeg_decode(data, len(data), int(full_range),
                                  out.ctypes.data), what)
    return out
