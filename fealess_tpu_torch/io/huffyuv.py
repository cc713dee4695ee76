"""Huffyuv frames as ``cv2.VideoCapture`` returns them (FFmpeg's
``huffyuv`` decoder, then swscale's bgr0 to BGR24), bit for bit: the codec
is lossless, so that is the frame the encoder was given.

Decoded on the host in C (``csrc/huffyuv_decode.c``, built at first use
and called through ctypes): what FFmpeg's encoder writes for
``cv2.VideoWriter``'s ``HFYU`` fourcc, version 2, RGB24, left prediction,
decorrelated, its tables in the extradata.  A stream of another version,
pixel layout, predictor or table placement raises
:class:`~fealess_tpu_torch.io.jpeg.UnsupportedImage` naming it; a frame
whose bits end before its last pixel (FFmpeg leaves the rest stale)
raises it too; corrupt tables raise
:class:`~fealess_tpu_torch.io.png.DecodeError`.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from fealess_tpu_torch.io.jpeg import UnsupportedImage
from fealess_tpu_torch.io.png import DecodeError

_LIB = None
_LIB_LOCK = threading.Lock()


def _lib():
    """The host library (built at first use)."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from fealess_tpu_torch.ops import _build
            lib = ctypes.CDLL(str(_build.build_host("huffyuv_decode")))
            lib.fl_huffyuv_open.argtypes = (ctypes.c_char_p, ctypes.c_long,
                                            ctypes.c_void_p)
            lib.fl_huffyuv_open.restype = ctypes.c_void_p
            lib.fl_huffyuv_decode.argtypes = (
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p)
            lib.fl_huffyuv_decode.restype = ctypes.c_int
            lib.fl_huffyuv_close.argtypes = (ctypes.c_void_p,)
            lib.fl_huffyuv_close.restype = None
            _LIB = lib
    return _LIB


class HuffyuvDecoder:
    """One Huffyuv stream of ``width`` x ``height`` with the extradata
    ``extradata``; :meth:`decode` takes its frames (each stands alone)."""

    def __init__(self, extradata: bytes, width: int, height: int,
                 what: str = "<stream>"):
        self.width, self.height, self.what = width, height, what
        info = np.zeros(6, np.int32)
        extradata = bytes(extradata)
        self._h = _lib().fl_huffyuv_open(extradata, len(extradata),
                                         info.ctypes.data)
        rc = int(info[0])
        if rc > 0:
            raise UnsupportedImage(
                f"{what}: Huffyuv version {info[1]} at {info[2]} bits a "
                f"pixel, predictor {info[3]}, decorrelate {info[4]}, "
                f"per-frame tables {info[5]} is read by cv2.VideoCapture but "
                f"not by the port (which reads what cv2.VideoWriter writes: "
                f"version 2, RGB24, left prediction, decorrelated)")
        if rc < 0 or not self._h:
            raise DecodeError(f"{what}: corrupt Huffyuv tables")

    def decode(self, data: bytes) -> np.ndarray:
        """The next frame as BGR u8 (H, W, 3)."""
        data = bytes(data)
        out = np.empty((self.height, self.width, 3), np.uint8)
        rc = _lib().fl_huffyuv_decode(self._h, data, len(data), self.width,
                                      self.height, out.ctypes.data)
        if rc == -3:
            raise UnsupportedImage(f"{self.what}: a Huffyuv frame whose bits "
                                   f"end before its last pixel")
        if rc:
            raise DecodeError(f"{self.what}: corrupt Huffyuv frame")
        return out

    def close(self) -> None:
        if self._h:
            _lib().fl_huffyuv_close(self._h)
            self._h = None

    def __del__(self):
        self.close()
