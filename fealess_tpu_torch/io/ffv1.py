"""FFV1 frames as ``cv2.VideoCapture`` returns them (FFmpeg's ``ffv1``
decoder, then swscale's bgr0 / bgra to BGR24), bit for bit: the codec is
lossless, so that is the frame the encoder was given.

Decoded on the host in C (``csrc/ffv1_decode.c``, built at first use and
called through ctypes): version 3 with Golomb-Rice coded samples, RGB at 8
bits, with or without alpha, any slice layout, slice CRCs checked, which is
what FFmpeg's encoder writes for ``cv2.VideoWriter``'s ``FFV1`` fourcc.  A
stream of another version, coder or colourspace raises
:class:`~fealess_tpu_torch.io.jpeg.UnsupportedImage` naming it; corrupt data
raises :class:`~fealess_tpu_torch.io.png.DecodeError`.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from fealess_tpu_torch.io.jpeg import UnsupportedImage
from fealess_tpu_torch.io.png import DecodeError

_ERRORS = {-1: "corrupt FFV1 data", -2: "FFV1 CRC mismatch",
           -3: "out of memory", -4: "a non-key frame before any key frame"}

_LIB = None
_LIB_LOCK = threading.Lock()


def _lib():
    """The host library (built at first use)."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from fealess_tpu_torch.ops import _build
            lib = ctypes.CDLL(str(_build.build_host("ffv1_decode")))
            lib.fl_ffv1_open.argtypes = (ctypes.c_char_p, ctypes.c_long,
                                         ctypes.c_int, ctypes.c_int,
                                         ctypes.c_void_p)
            lib.fl_ffv1_open.restype = ctypes.c_void_p
            lib.fl_ffv1_decode.argtypes = (ctypes.c_void_p, ctypes.c_char_p,
                                           ctypes.c_long, ctypes.c_void_p)
            lib.fl_ffv1_decode.restype = ctypes.c_int
            lib.fl_ffv1_close.argtypes = (ctypes.c_void_p,)
            lib.fl_ffv1_close.restype = None
            _LIB = lib
    return _LIB


class FFV1Decoder:
    """One FFV1 stream of ``width`` x ``height`` with the configuration
    record ``extradata``; :meth:`decode` takes its frames in order (a
    non-key frame reuses the context states of the frame before)."""

    def __init__(self, extradata: bytes, width: int, height: int,
                 what: str = "<stream>"):
        self.width, self.height, self.what = width, height, what
        info = np.zeros(6, np.int32)
        extradata = bytes(extradata)
        self._h = _lib().fl_ffv1_open(extradata, len(extradata), width,
                                      height, info.ctypes.data)
        rc = int(info[0])
        if rc > 0:
            kind = {1: f"FFV1 version {info[1]}",
                    2: f"FFV1 with range-coded samples (coder {info[2]})",
                    3: f"FFV1 colourspace {info[3]} at {info[4]} bits"}[rc]
            raise UnsupportedImage(f"{what}: {kind} is read by "
                                   f"cv2.VideoCapture but not by the port "
                                   f"(which reads what cv2.VideoWriter "
                                   f"writes: version 3, Golomb-Rice, RGB "
                                   f"at 8 bits)")
        if rc < 0 or not self._h:
            raise DecodeError(f"{what}: "
                              f"{_ERRORS.get(rc, 'corrupt FFV1 header')}")

    def decode(self, data: bytes) -> np.ndarray:
        """The next frame as BGR u8 (H, W, 3)."""
        data = bytes(data)
        out = np.empty((self.height, self.width, 3), np.uint8)
        rc = _lib().fl_ffv1_decode(self._h, data, len(data),
                                   out.ctypes.data)
        if rc:
            raise DecodeError(f"{self.what}: "
                              f"{_ERRORS.get(rc, 'corrupt FFV1 data')}")
        return out

    def close(self) -> None:
        if self._h:
            _lib().fl_ffv1_close(self._h)
            self._h = None

    def __del__(self):
        self.close()
