"""Raw video frames as ``cv2.VideoCapture`` returns them: FFmpeg's
``rawvideo`` decoder hands the packet's planes on as they lie, and swscale
converts them to BGR24 (``csrc/yuv_planar.c`` over ``csrc/yuv_bgr.h``, the
converters the Motion JPEG decoder uses; host C built at first use and
called through ctypes).

The container's fourcc (AVI's compression, Matroska's ``ColourSpace``,
MOV's sample entry; FFmpeg's ``codec_tag``) picks the pixel format, as
``raw_init_decoder`` looks it up in FFmpeg's raw tags (:data:`RAW_FOURCCS`):

- ``yuv420p``, at limited range unless the stream says full range
  (YUV4MPEG2's ``XCOLORRANGE=FULL``): ``I420`` and ``IYUV`` (what
  ``cv2.VideoWriter`` writes for fourcc 0 and for every fourcc of 4:2:0)
  and ``YV12`` (the same with V before U);
- ``gray``: ``Y800``, ``Y8  ``, ``GREY`` (and YUV4MPEG2's ``Cmono``).
  swscale copies the byte into B, G and R with no range expansion;
  ``cv2.VideoWriter`` stores yuv420p planes under these fourccs, of which
  the decoder reads the luma;
- ``nv12``: ``NV12``, 4:2:0 with U and V interleaved in one plane.
  x86's swscale has no unscaled converter for it: it takes the scaler's
  path at every size;
- ``rgba``: ``RGBA``, swapped to BGR exactly.

A frame's planes lie back to back: luma W x H, then chroma ceil(W / 2) x
ceil(H / 2) (twice over, or once at twice the width for NV12), or W x H
pixels of 4 bytes.  FFmpeg widens a gray row, and NV12's two planes' rows,
to a multiple of 4 bytes where the packet holds the widened frame
(``raw_decode``'s ``linesize_align``).  A packet shorter than the frame is
refused by the decoder (:class:`~fealess_tpu_torch.io.png.DecodeError`);
bytes past it are ignored.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from fealess_tpu_torch.io.png import DecodeError

# fourcc -> the pixel format FFmpeg's raw tags give it
RAW_FOURCCS = {b"I420": "yuv420p", b"IYUV": "yuv420p", b"YV12": "yvu420p",
               b"Y800": "gray", b"Y8  ": "gray", b"GREY": "gray",
               b"NV12": "nv12", b"RGBA": "rgba"}

_LIB = None
_LIB_LOCK = threading.Lock()


def _lib():
    """The host library (built at first use)."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from fealess_tpu_torch.ops import _build
            lib = ctypes.CDLL(str(_build.build_host("yuv_planar")))
            for fn in (lib.fl_yuv420p_to_bgr, lib.fl_yuv420p_scaled_to_bgr):
                fn.argtypes = (
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_void_p)
                fn.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def frame_size(width: int, height: int, fmt: str = "yuv420p") -> int:
    """Bytes of one frame of ``fmt`` with no row padding."""
    if fmt == "gray":
        return width * height
    if fmt == "rgba":
        return 4 * width * height
    return width * height + 2 * ((width + 1) // 2) * ((height + 1) // 2)


def yuv420p_to_bgr(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                   full_range: bool = False,
                   scaled: bool = False) -> np.ndarray:
    """u8 planes, luma (H, W) and chroma (ceil(H/2), ceil(W/2)), each with
    unit column stride, to BGR u8 (H, W, 3) as swscale converts them
    (``scaled``: through its scaler, as for NV12)."""
    h, w = y.shape
    cw, ch = (w + 1) // 2, (h + 1) // 2
    if u.shape != (ch, cw) or v.shape != (ch, cw) or \
            u.strides != v.strides or \
            any(p.dtype != np.uint8 or p.strides[1] != 1 for p in (y, u, v)):
        raise ValueError(f"yuv420p planes {y.shape}, {u.shape}, {v.shape}")
    out = np.empty((h, w, 3), np.uint8)
    strides = np.array([y.strides[0], u.strides[0]], np.int64)
    lib = _lib()
    fn = lib.fl_yuv420p_scaled_to_bgr if scaled else lib.fl_yuv420p_to_bgr
    rc = fn(y.ctypes.data, u.ctypes.data, v.ctypes.data,
            strides.ctypes.data, w, h, int(full_range), out.ctypes.data)
    if rc:
        raise MemoryError("fl_yuv420p_to_bgr: out of memory")
    return out


def _aligned(n: int) -> int:
    return (n + 3) & ~3


def decode_raw(data: bytes, width: int, height: int, fmt: str,
               what: str = "<frame>", full_range: bool = False) -> np.ndarray:
    """One raw frame of the pixel format ``fmt`` (a value of
    :data:`RAW_FOURCCS`) as BGR u8 (H, W, 3)."""
    need = frame_size(width, height, fmt)
    if len(data) < need:
        raise DecodeError(f"{what}: raw {fmt} frame of {len(data)} bytes, "
                          f"expected {need}")
    buf = np.frombuffer(data, np.uint8)
    cw, ch = (width + 1) // 2, (height + 1) // 2
    if fmt == "gray":
        stride = width
        if _aligned(width) * height <= len(data):
            stride = _aligned(width)
        y = buf[:stride * height].reshape(height, stride)[:, :width]
        return np.repeat(y[:, :, None], 3, axis=2)
    if fmt == "rgba":
        rgba = buf[:need].reshape(height, width, 4)
        return np.ascontiguousarray(rgba[:, :, 2::-1])
    if fmt == "nv12":
        s0, s1 = width, 2 * cw
        if _aligned(s0) * height + _aligned(s1) * ch <= len(data):
            s0, s1 = _aligned(s0), _aligned(s1)
        y = buf[:s0 * height].reshape(height, s0)[:, :width]
        uv = buf[s0 * height:s0 * height + s1 * ch].reshape(ch, s1)
        u, v = uv[:, 0:2 * cw:2].copy(), uv[:, 1:2 * cw:2].copy()
        return yuv420p_to_bgr(y, u, v, full_range, scaled=True)
    n = width * height
    y = buf[:n].reshape(height, width)
    first = buf[n:n + cw * ch].reshape(ch, cw)
    second = buf[n + cw * ch:need].reshape(ch, cw)
    u, v = (second, first) if fmt == "yvu420p" else (first, second)
    return yuv420p_to_bgr(y, u, v, full_range)
