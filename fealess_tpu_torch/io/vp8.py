"""VP8 video as ``cv2.VideoCapture`` returns it (FFmpeg's native ``vp8``
decoder, then swscale's yuv420p to BGR24), bit for bit: what
``cv2.VideoWriter`` writes with the fourcc ``VP80`` in AVI, Matroska and
WebM (libvpx: key and inter frames, the golden and altref references,
loop-filter deltas, probability updates), and the header tools the
committed clips re-encode (versions 1-3, the simple filter, sharpness,
2-8 token partitions, reference copies, sign biases, kept
probabilities, no skip flags, hidden frames).

Decoded on the host in C (``csrc/vp8_decode.c``, RFC 6386; built at first
use and called through ctypes); a :class:`Vp8Decoder` keeps the three
reference frames (last, golden, altref), the probabilities and the
loop-filter deltas across packets.  A tool no committed clip holds raises
:class:`~fealess_tpu_torch.io.jpeg.UnsupportedImage` naming it
(:data:`REFUSED`); a packet FFmpeg rejects, or one whose frame FFmpeg's
end-of-data check stops part way, raises
:class:`~fealess_tpu_torch.io.png.DecodeError`.  A frame with
``show_frame`` 0 is decoded into the references and gives no frame
(:meth:`Vp8Decoder.decode` returns None), as FFmpeg outputs none for it.
The frame size is each key frame's, as in FFmpeg's decoder.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from fealess_tpu_torch.io.jpeg import UnsupportedImage
from fealess_tpu_torch.io.png import DecodeError

# the codes of csrc/vp8_decode.c's R_* refusals
REFUSED = {
    1: "a version (profile) above 3",
    2: "segmentation",
    3: "a key frame that changes the frame size",
    4: "clamping_type 1 (FFmpeg's full range, which cv2's conversion takes "
       "up or not by its frame thread)"}
_REFUSED_BASE = 100

# csrc/vp8_decode.c's C_* syntax path counters, in order
PATHS = ("KEY_FRAME", "INTER_FRAME", "HIDDEN_FRAME", "SCALE_BITS",
         "COLOR_SPACE",
         "VERSION0", "BILINEAR", "FULL_PIXEL", "LF_DELTA_UPDATE",
         "QUANT_DELTA", "REFRESH_GOLDEN", "REFRESH_ALTREF",
         "COPY_LAST_TO_GOLDEN", "COPY_ALTREF_TO_GOLDEN",
         "COPY_LAST_TO_ALTREF", "COPY_GOLDEN_TO_ALTREF", "SIGN_BIAS",
         "KEEP_LAST", "KEEP_PROBS", "COEF_PROB_UPDATE", "YMODE_PROB_UPDATE",
         "UVMODE_PROB_UPDATE", "MV_PROB_UPDATE", "NO_SKIP_FLAG", "MB_SKIP",
         "MB_NO_COEFFS", "KF_I16", "KF_BPRED", "INTER_I16", "INTER_BPRED",
         "I16_DC", "I16_V", "I16_H", "I16_TM", "B_DC", "B_TM", "B_VE",
         "B_HE", "B_LD", "B_RD", "B_VR", "B_VL", "B_HD", "B_HU", "UV_DC",
         "UV_V", "UV_H", "UV_TM", "REF_LAST", "REF_GOLDEN", "REF_ALTREF",
         "ZEROMV", "NEARESTMV", "NEARMV", "NEWMV", "SPLITMV", "SPLIT_16X8",
         "SPLIT_8X16", "SPLIT_8X8", "SPLIT_4X4", "SUB_LEFT", "SUB_ABOVE",
         "SUB_ZERO", "SUB_NEW", "MV_SHORT", "MV_LONG", "MV_CLAMPED",
         "TOKEN_CAT1", "TOKEN_CAT2", "TOKEN_CAT3", "TOKEN_CAT4",
         "TOKEN_CAT5", "TOKEN_CAT6", "WHT", "WHT_DC", "IDCT", "IDCT_DC",
         "MC_FULL", "MC_H", "MC_V", "MC_HV", "MC_EDGE", "LF_OFF",
         "LF_NORMAL", "LF_SIMPLE", "LF_SHARPNESS", "LF_MB_EDGE", "LF_INNER",
         "LF_HEV", "PARTITIONS")

# the AVI / VfW fourcc and the Matroska CodecID FFmpeg decodes as VP8
FOURCCS = (b"VP80",)
CODEC_ID = "V_VP8"

_LIB = None
_LIB_LOCK = threading.Lock()


def _lib():
    """The host library (built at first use)."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from fealess_tpu_torch.ops import _build
            lib = ctypes.CDLL(str(_build.build_host("vp8_decode")))
            lib.fl_vp8_open.argtypes = ()
            lib.fl_vp8_open.restype = ctypes.c_void_p
            lib.fl_vp8_decode.argtypes = (ctypes.c_void_p, ctypes.c_char_p,
                                          ctypes.c_long, ctypes.c_void_p)
            lib.fl_vp8_decode.restype = ctypes.c_int
            lib.fl_vp8_bgr.argtypes = (ctypes.c_void_p, ctypes.c_void_p)
            lib.fl_vp8_bgr.restype = ctypes.c_int
            lib.fl_vp8_planes.argtypes = (ctypes.c_void_p,) + \
                (ctypes.c_void_p,) * 3
            lib.fl_vp8_planes.restype = None
            lib.fl_vp8_counts.argtypes = (ctypes.c_void_p, ctypes.c_void_p)
            lib.fl_vp8_counts.restype = None
            lib.fl_vp8_npaths.argtypes = ()
            lib.fl_vp8_npaths.restype = ctypes.c_int
            lib.fl_vp8_trace_on.argtypes = (ctypes.c_void_p, ctypes.c_long)
            lib.fl_vp8_trace_on.restype = ctypes.c_int
            lib.fl_vp8_trace.argtypes = (ctypes.c_void_p, ctypes.c_int) + \
                (ctypes.c_void_p,) * 3 + (ctypes.c_long, ctypes.c_void_p)
            lib.fl_vp8_trace.restype = None
            lib.fl_vp8_modes.argtypes = (ctypes.c_void_p, ctypes.c_void_p)
            lib.fl_vp8_modes.restype = None
            lib.fl_vp8_replay.argtypes = (ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_long, ctypes.c_void_p,
                                          ctypes.c_long)
            lib.fl_vp8_replay.restype = None
            lib.fl_vp8_close.argtypes = (ctypes.c_void_p,)
            lib.fl_vp8_close.restype = None
            assert lib.fl_vp8_npaths() == len(PATHS)
            _LIB = lib
    return _LIB


class Vp8Decoder:
    """One VP8 stream; :meth:`decode` takes its packets in order.  ``path``
    and ``container`` (e.g. "AVI") go into the messages."""

    def __init__(self, path: str = "<stream>", container: str = ""):
        self.what = path
        self.kind = (f"{container} with " if container else "") + \
            "VP8 video"
        self._h = _lib().fl_vp8_open()
        if not self._h:
            raise MemoryError("fl_vp8_open: out of memory")

    def _check(self, rc: int) -> None:
        if rc >= _REFUSED_BASE:
            tool = REFUSED.get(rc - _REFUSED_BASE, f"tool {rc}")
            raise UnsupportedImage(
                f"{self.what}: {self.kind} using {tool} is read by "
                f"cv2.VideoCapture but not by the port (which reads VP8 "
                f"versions 0-3 without segmentation)")
        if rc == -2:
            raise MemoryError("fl_vp8_decode: out of memory")
        if rc < 0:
            raise DecodeError(f"{self.what}: corrupt VP8 packet")

    def decode(self, data: bytes) -> Optional[np.ndarray]:
        """The packet's frame as BGR u8 (H, W, 3), or None for a frame
        that is not shown."""
        data = bytes(data)
        wh = np.zeros(2, np.int32)
        rc = _lib().fl_vp8_decode(self._h, data, len(data), wh.ctypes.data)
        if rc == 1:
            return None
        self._check(rc)
        out = np.empty((int(wh[1]), int(wh[0]), 3), np.uint8)
        if _lib().fl_vp8_bgr(self._h, out.ctypes.data):
            raise MemoryError("fl_vp8_bgr: out of memory")
        return out

    def planes(self, width: int, height: int):
        """The last frame's yuv420p planes (y, u, v), cropped to its size."""
        cw, ch = (width + 1) // 2, (height + 1) // 2
        y = np.empty((height, width), np.uint8)
        u = np.empty((ch, cw), np.uint8)
        v = np.empty((ch, cw), np.uint8)
        _lib().fl_vp8_planes(self._h, y.ctypes.data, u.ctypes.data,
                             v.ctypes.data)
        return y, u, v

    def modes(self, width: int, height: int) -> np.ndarray:
        """The last frame's macroblock modes (rows, columns): 0-3 the
        16x16 intra modes, 4 B_PRED, 5-9 ZEROMV, NEARESTMV, NEARMV, NEWMV,
        SPLITMV."""
        out = np.empty(((height + 15) // 16, (width + 15) // 16), np.uint8)
        _lib().fl_vp8_modes(self._h, out.ctypes.data)
        return out

    def counts(self) -> Dict[str, int]:
        """How often each syntax path (:data:`PATHS`) was decoded."""
        out = np.zeros(len(PATHS), np.uint64)
        _lib().fl_vp8_counts(self._h, out.ctypes.data)
        return dict(zip(PATHS, (int(v) for v in out)))

    def trace(self, cap: int = 1 << 22) -> None:
        """Keep the bools each later packet's partitions decode, up to
        ``cap`` a partition (for the tests, which re-encode a stream with
        a header field or the partitioning changed)."""
        if _lib().fl_vp8_trace_on(self._h, cap):
            raise MemoryError("fl_vp8_trace_on: out of memory")

    def traced(self, k: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The last packet's (probabilities, bits, marks) of its first
        partition (``k`` 0) or its token partitions (``k`` 1), with a mark
        where each macroblock starts."""
        n = np.zeros(2, np.int64)
        _lib().fl_vp8_trace(self._h, k, None, None, None, 0, n.ctypes.data)
        cap = int(max(n))
        prob, bit = np.empty(cap, np.uint8), np.empty(cap, np.uint8)
        mark = np.empty(cap, np.int64)
        _lib().fl_vp8_trace(self._h, k, prob.ctypes.data, bit.ctypes.data,
                            mark.ctypes.data, cap, n.ctypes.data)
        return prob[:n[0]], bit[:n[0]], mark[:n[1]]

    def replay(self, data: bytes, first: np.ndarray,
               tokens: np.ndarray) -> Optional[np.ndarray]:
        """:meth:`decode` ``data`` (its frame tag and partition layout)
        with its first partition's and token partitions' bits replaced by
        ``first`` and ``tokens``; :meth:`traced` then gives the
        probabilities each bit was read with.  Needs :meth:`trace`."""
        first = np.ascontiguousarray(first, np.uint8)
        tokens = np.ascontiguousarray(tokens, np.uint8)
        _lib().fl_vp8_replay(self._h, first.ctypes.data, len(first),
                             tokens.ctypes.data, len(tokens))
        try:
            return self.decode(data)
        finally:
            _lib().fl_vp8_replay(self._h, None, 0, None, 0)

    def close(self) -> None:
        if self._h:
            _lib().fl_vp8_close(self._h)
            self._h = None

    def __del__(self):
        self.close()
