"""H.263 baseline and Sorenson Spark video as ``cv2.VideoCapture`` returns
it (FFmpeg's ``h263`` and ``flv`` decoders, then swscale's yuv420p to
BGR24), bit for bit, for what ``cv2.VideoWriter`` writes: H.263 with the
fourccs ``H263``, ``U263``, ``h263`` and ``s263`` (in MOV and 3GP/3G2) at
its five picture sizes, Sorenson Spark with ``FLV1`` (and ``s263`` in the
other containers) at any size.  Both are FFmpeg's own encoders: I and P
pictures, one quantiser a picture, no GOB headers and no annex of H.263;
Sorenson's version 1 escape (7- or 11-bit levels).

Decoded on the host in C (``csrc/h263_decode.c``, which shares its
macroblock layer ``csrc/h263_mb.h`` with the MPEG-4 Part 2 decoder, built
at first use and called through ctypes); a :class:`H263Decoder` keeps the
reference picture and the vectors across packets.  A tool no such stream
holds raises :class:`~fealess_tpu_torch.io.jpeg.UnsupportedImage` naming
it (:data:`REFUSED`); a packet the decoder cannot read raises
:class:`~fealess_tpu_torch.io.png.DecodeError`.  A Sorenson picture of
type 2 (disposable) is decoded from the reference and does not replace
it, as FFmpeg decodes it.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict

import numpy as np

from fealess_tpu_torch.io.jpeg import UnsupportedImage
from fealess_tpu_torch.io.png import DecodeError

# the codes of csrc/h263_decode.c's R_* refusals
REFUSED = {
    1: "PLUSPTYPE (H.263+, source format 6 or 7)",
    2: "unrestricted motion vectors (Annex D)",
    3: "syntax-based arithmetic coding (Annex E)",
    4: "advanced prediction (Annex F)", 5: "PB-frames (Annex G)",
    6: "continuous presence multipoint (CPM)", 7: "GOB headers",
    8: "DQUANT", 9: "4MV (INTER4V macroblocks)", 10: "macroblock stuffing",
    11: "a picture that changes the frame size",
    12: "a P picture before any I picture"}
_REFUSED_BASE = 100

# csrc/h263_decode.c's C_* syntax path counters, in order
PATHS = ("SQCIF", "QCIF", "CIF", "4CIF", "16CIF", "VERSION0", "VERSION1",
         "SIZE_8BIT", "SIZE_16BIT", "SIZE_FIXED", "DEBLOCK_OFF",
         "PEI_SPARE", "IPIC", "PPIC", "DISPOSABLE_P", "I_MB", "P_INTRA_MB",
         "P_INTER_MB", "P_SKIP_MB", "ESC8", "ESC7", "ESC11", "MV_ZERO_CODE",
         "MV_CODED", "MC_FULL", "MC_X", "MC_Y", "MC_XY", "MC_CLAMPED")
# the paths that belong to one flavour only
H263_PATHS = ("SQCIF", "QCIF", "CIF", "4CIF", "16CIF")
SORENSON_PATHS = ("VERSION0", "VERSION1", "SIZE_8BIT", "SIZE_16BIT",
                  "SIZE_FIXED", "DEBLOCK_OFF", "DISPOSABLE_P", "ESC7",
                  "ESC11")

# the AVI fourccs FFmpeg maps to each decoder that cv2.VideoWriter writes
H263_FOURCCS = (b"H263", b"U263")
SORENSON_FOURCCS = (b"FLV1",)
FLAVOURS = ("h263", "sorenson")
NAMES = {"h263": "H.263", "sorenson": "Sorenson Spark"}

_LIB = None
_LIB_LOCK = threading.Lock()


def _lib():
    """The host library (built at first use)."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from fealess_tpu_torch.ops import _build
            lib = ctypes.CDLL(str(_build.build_host("h263_decode")))
            lib.fl_h263_open.argtypes = (ctypes.c_int,)
            lib.fl_h263_open.restype = ctypes.c_void_p
            lib.fl_h263_decode.argtypes = (ctypes.c_void_p, ctypes.c_char_p,
                                           ctypes.c_long, ctypes.c_void_p)
            lib.fl_h263_decode.restype = ctypes.c_int
            lib.fl_h263_bgr.argtypes = (ctypes.c_void_p, ctypes.c_void_p)
            lib.fl_h263_bgr.restype = ctypes.c_int
            lib.fl_h263_planes.argtypes = (ctypes.c_void_p,) + \
                (ctypes.c_void_p,) * 3
            lib.fl_h263_planes.restype = None
            lib.fl_h263_counts.argtypes = (ctypes.c_void_p, ctypes.c_void_p)
            lib.fl_h263_counts.restype = ctypes.c_int
            lib.fl_h263_close.argtypes = (ctypes.c_void_p,)
            lib.fl_h263_close.restype = None
            _LIB = lib
    return _LIB


class H263Decoder:
    """One H.263 (``flavour`` ``"h263"``) or Sorenson Spark
    (``"sorenson"``) stream; :meth:`decode` takes its packets in order.
    FFmpeg reads no extradata of either codec, so ``extradata`` is
    ignored; the container's ``fourcc`` (b"" for none), ``what`` and
    ``container`` (e.g. "AVI") go into the messages."""

    def __init__(self, extradata: bytes = b"", fourcc: bytes = b"",
                 what: str = "<stream>", container: str = "",
                 flavour: str = "h263"):
        self._h = None
        if flavour not in FLAVOURS:
            raise ValueError(f"flavour {flavour!r}: one of {FLAVOURS}")
        self.what, self.flavour = what, flavour
        tag = f" ({fourcc.decode('latin-1')})" if fourcc else ""
        self.kind = (f"{container} with " if container else "") + \
            f"{NAMES[flavour]} video{tag}"
        self._h = _lib().fl_h263_open(flavour == "sorenson")
        if not self._h:
            raise MemoryError("fl_h263_open: out of memory")

    def _check(self, rc: int) -> None:
        if rc >= _REFUSED_BASE:
            tool = REFUSED.get(rc - _REFUSED_BASE, f"tool {rc}")
            raise UnsupportedImage(
                f"{self.what}: {self.kind} using {tool} is read by "
                f"cv2.VideoCapture but not by the port (which reads what "
                f"cv2.VideoWriter writes: I and P pictures, one quantiser "
                f"a picture, no GOB headers, no H.263 annex)")
        if rc == -2:
            raise MemoryError("fl_h263_decode: out of memory")
        if rc < 0:
            raise DecodeError(f"{self.what}: corrupt {NAMES[self.flavour]} "
                              f"packet")

    def decode(self, data: bytes) -> np.ndarray:
        """The packet's frame as BGR u8 (H, W, 3)."""
        data = bytes(data)
        wh = np.zeros(2, np.int32)
        self._check(_lib().fl_h263_decode(self._h, data, len(data),
                                          wh.ctypes.data))
        out = np.empty((int(wh[1]), int(wh[0]), 3), np.uint8)
        if _lib().fl_h263_bgr(self._h, out.ctypes.data):
            raise MemoryError("fl_h263_bgr: out of memory")
        return out

    def planes(self, width: int, height: int):
        """The last frame's yuv420p planes (y, u, v), cropped to its size."""
        cw, ch = (width + 1) // 2, (height + 1) // 2
        y = np.empty((height, width), np.uint8)
        u = np.empty((ch, cw), np.uint8)
        v = np.empty((ch, cw), np.uint8)
        _lib().fl_h263_planes(self._h, y.ctypes.data, u.ctypes.data,
                              v.ctypes.data)
        return y, u, v

    def counts(self) -> Dict[str, int]:
        """How often each syntax path (:data:`PATHS`) was decoded."""
        out = np.zeros(len(PATHS), np.uint64)
        _lib().fl_h263_counts(self._h, out.ctypes.data)
        return dict(zip(PATHS, (int(v) for v in out)))

    def close(self) -> None:
        if self._h:
            _lib().fl_h263_close(self._h)
            self._h = None

    def __del__(self):
        self.close()
