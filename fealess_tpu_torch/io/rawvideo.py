"""Raw planar YUV frames as ``cv2.VideoCapture`` returns them: FFmpeg's
``rawvideo`` decoder hands the packet's planes on as they lie, and swscale
converts them to BGR24 (``csrc/yuv_planar.c`` over ``csrc/yuv_bgr.h``, the
converters the Motion JPEG decoder uses; host C built at first use and
called through ctypes).

Read: 4:2:0 planar, ``yuv420p`` at limited range, the format FFmpeg gives
the fourccs ``I420`` and ``IYUV`` (what ``cv2.VideoWriter`` writes for
fourcc 0 and for every raw fourcc) and ``YV12`` (the same with V before U).
A frame's planes lie back to back with no padding: luma W x H, then each
chroma plane ceil(W / 2) x ceil(H / 2).  A packet shorter than that is
refused by the decoder (:class:`~fealess_tpu_torch.io.png.DecodeError`);
bytes past it are ignored.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from fealess_tpu_torch.io.png import DecodeError

# fourcc -> U before V
YUV420P_FOURCCS = {b"I420": True, b"IYUV": True, b"YV12": False}

_LIB = None
_LIB_LOCK = threading.Lock()


def _lib():
    """The host library (built at first use)."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from fealess_tpu_torch.ops import _build
            lib = ctypes.CDLL(str(_build.build_host("yuv_planar")))
            lib.fl_yuv420p_to_bgr.argtypes = (
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p)
            lib.fl_yuv420p_to_bgr.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def frame_size(width: int, height: int) -> int:
    """Bytes of one yuv420p frame."""
    return width * height + 2 * ((width + 1) // 2) * ((height + 1) // 2)


def yuv420p_to_bgr(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                   full_range: bool = False) -> np.ndarray:
    """u8 planes, luma (H, W) and chroma (ceil(H/2), ceil(W/2)), each with
    unit column stride, to BGR u8 (H, W, 3) as swscale converts them."""
    h, w = y.shape
    cw, ch = (w + 1) // 2, (h + 1) // 2
    if u.shape != (ch, cw) or v.shape != (ch, cw) or \
            u.strides != v.strides or \
            any(p.dtype != np.uint8 or p.strides[1] != 1 for p in (y, u, v)):
        raise ValueError(f"yuv420p planes {y.shape}, {u.shape}, {v.shape}")
    out = np.empty((h, w, 3), np.uint8)
    strides = np.array([y.strides[0], u.strides[0]], np.int64)
    rc = _lib().fl_yuv420p_to_bgr(y.ctypes.data, u.ctypes.data,
                                  v.ctypes.data, strides.ctypes.data, w, h,
                                  int(full_range), out.ctypes.data)
    if rc:
        raise MemoryError("fl_yuv420p_to_bgr: out of memory")
    return out


def decode_yuv420p(data: bytes, width: int, height: int,
                   u_first: bool = True, what: str = "<frame>") -> np.ndarray:
    """One raw yuv420p frame (``u_first`` False: YV12's V, U order) as BGR
    u8 (H, W, 3)."""
    need = frame_size(width, height)
    if len(data) < need:
        raise DecodeError(f"{what}: raw yuv420p frame of {len(data)} bytes, "
                          f"expected {need}")
    buf = np.frombuffer(data, np.uint8, need)
    cw, ch = (width + 1) // 2, (height + 1) // 2
    n = width * height
    y = buf[:n].reshape(height, width)
    first = buf[n:n + cw * ch].reshape(ch, cw)
    second = buf[n + cw * ch:].reshape(ch, cw)
    u, v = (first, second) if u_first else (second, first)
    return yuv420p_to_bgr(y, u, v)
