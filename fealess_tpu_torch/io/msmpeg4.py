"""MS MPEG-4 v2, MS MPEG-4 v3 and WMV7 video as ``cv2.VideoCapture``
returns it (FFmpeg's ``msmpeg4v2``, ``msmpeg4v3`` and ``wmv1`` decoders,
then swscale's yuv420p to BGR24), bit for bit, for what
``cv2.VideoWriter`` writes with the fourccs of :data:`FOURCCS`: FFmpeg's
own msmpeg4 encoder, I and P pictures, one slice and one quantiser a
picture, no AC prediction.  The stream carries no picture size; the
container's is the decoder's.

Decoded on the host in C (``csrc/msmpeg4_decode.c``, which shares its
macroblock layer ``csrc/h263_mb.h`` with the H.263 and MPEG-4 Part 2
decoders and takes Microsoft's tables from ``csrc/msmpeg4_tables.h``,
built at first use and called through ctypes); an :class:`MSMPEG4Decoder`
keeps the reference picture, the vectors and the rounding state across
packets.  A tool no such stream holds raises
:class:`~fealess_tpu_torch.io.jpeg.UnsupportedImage` naming it
(:data:`REFUSED`); a packet the decoder cannot read raises
:class:`~fealess_tpu_torch.io.png.DecodeError`.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict

import numpy as np

from fealess_tpu_torch.io.jpeg import UnsupportedImage
from fealess_tpu_torch.io.png import DecodeError

# the codes of csrc/msmpeg4_decode.c's R_* refusals
REFUSED = {
    1: "AC prediction", 2: "a run/level table chosen per macroblock",
    3: "more than one slice", 4: "a P picture before any I picture",
    5: "DC table 0", 6: "MV table 0", 7: "P pictures without skip flags"}
_REFUSED_BASE = 100

# csrc/msmpeg4_decode.c's C_* syntax path counters, in order (C_PATHS):
# those these three codecs take (PATHS), then WMV8's CBP tables
# (io/wmv2.py)
PATHS = ("IPIC", "PPIC", "ROUND0", "ROUND1", "EXT_HEADER", "RL0", "RL1",
         "RL2", "RL3", "RL4", "RL5", "I_MB", "P_INTRA_MB", "P_INTER_MB",
         "P_SKIP_MB", "CBP_PRED", "INTER_INTRA", "DC_ESCAPE", "DC_LEFT",
         "DC_TOP", "ESC1", "ESC2", "ESC3", "ESC3_LENGTHS", "MV_ESCAPE",
         "MV_ZERO_CODE", "MV_CODED", "MC_FULL", "MC_X", "MC_Y", "MC_XY",
         "MC_CLAMPED")
C_PATHS = PATHS + ("CBP_TABLE0", "CBP_TABLE1", "CBP_TABLE2")
# FFmpeg's three decoders (the port's codec names), the AVI fourccs it
# maps to each (cv2.VideoWriter writes each), and the version
# csrc/msmpeg4_decode.c takes for each
FOURCCS = {"msmpeg4v2": (b"MP42", b"DIV2"),
           "msmpeg4v3": (b"DIV3", b"MP43", b"DIV4", b"DIV5", b"DIV6",
                         b"MPG3", b"AP41", b"COL1", b"COL0", b"3IVD"),
           "wmv1": (b"WMV1",)}
VERSIONS = {"msmpeg4v2": 2, "msmpeg4v3": 3, "wmv1": 4}
NAMES = {"msmpeg4v2": "MS MPEG-4 v2", "msmpeg4v3": "MS MPEG-4 v3",
         "wmv1": "WMV7"}


def codec_of(fourcc: bytes) -> str:
    """The decoder (a key of :data:`FOURCCS`) FFmpeg takes for
    ``fourcc``, or ""."""
    for codec, ccs in FOURCCS.items():
        if fourcc in ccs:
            return codec
    return ""


_LIB = None
_LIB_LOCK = threading.Lock()


def _lib():
    """The host library (built at first use)."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from fealess_tpu_torch.ops import _build
            lib = ctypes.CDLL(str(_build.build_host("msmpeg4_decode")))
            lib.fl_msmpeg4_open.argtypes = (ctypes.c_int,) * 3
            lib.fl_msmpeg4_open.restype = ctypes.c_void_p
            lib.fl_msmpeg4_decode.argtypes = (ctypes.c_void_p,
                                              ctypes.c_char_p, ctypes.c_long)
            lib.fl_msmpeg4_decode.restype = ctypes.c_int
            lib.fl_msmpeg4_bgr.argtypes = (ctypes.c_void_p, ctypes.c_void_p)
            lib.fl_msmpeg4_bgr.restype = ctypes.c_int
            lib.fl_msmpeg4_planes.argtypes = (ctypes.c_void_p,) + \
                (ctypes.c_void_p,) * 3
            lib.fl_msmpeg4_planes.restype = None
            lib.fl_msmpeg4_counts.argtypes = (ctypes.c_void_p,
                                              ctypes.c_void_p)
            lib.fl_msmpeg4_counts.restype = ctypes.c_int
            lib.fl_msmpeg4_ext_header.argtypes = (
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long)
            lib.fl_msmpeg4_ext_header.restype = ctypes.c_int
            lib.fl_msmpeg4_close.argtypes = (ctypes.c_void_p,)
            lib.fl_msmpeg4_close.restype = None
            _LIB = lib
    return _LIB


class MSMPEG4Decoder:
    """One MS MPEG-4 v2 (``codec`` ``"msmpeg4v2"``), v3 (``"msmpeg4v3"``)
    or WMV7 (``"wmv1"``) stream of ``width`` x ``height`` pictures (the
    container's: FFmpeg reads no extradata of these codecs);
    :meth:`decode` takes its packets in order.  The container's ``fourcc``
    (b"" for none), ``what`` and ``container`` (e.g. "AVI") go into the
    messages."""

    # the refusals' names, the paths counted and what the writer writes,
    # as a subclass for another of the C decoder's versions has its own
    refused = REFUSED
    paths = PATHS
    writes = ("I and P pictures, one slice, no AC prediction, one "
              "run/level table set a picture")

    def __init__(self, codec: str, width: int, height: int,
                 fourcc: bytes = b"", what: str = "<stream>",
                 container: str = ""):
        self._h = None
        if codec not in VERSIONS:
            raise ValueError(f"codec {codec!r}: one of {tuple(VERSIONS)}")
        self.codec = codec
        self._open(VERSIONS[codec], NAMES[codec], width, height, fourcc,
                   what, container)

    def _open(self, version: int, name: str, width: int, height: int,
              fourcc: bytes, what: str, container: str) -> None:
        self.what, self.name = what, name
        self.width, self.height = int(width), int(height)
        tag = f" ({fourcc.decode('latin-1')})" if fourcc else ""
        self.kind = (f"{container} with " if container else "") + \
            f"{name} video{tag}"
        if not (0 < self.width <= 16384 and 0 < self.height <= 16384):
            raise DecodeError(f"{what}: {self.kind} of size {self.width}x"
                              f"{self.height}")
        self._h = _lib().fl_msmpeg4_open(version, self.width, self.height)
        if not self._h:
            raise MemoryError("fl_msmpeg4_open: out of memory")

    def _check(self, rc: int) -> None:
        if rc >= _REFUSED_BASE:
            tool = self.refused.get(rc - _REFUSED_BASE, f"tool {rc}")
            raise UnsupportedImage(
                f"{self.what}: {self.kind} using {tool} is read by "
                f"cv2.VideoCapture but not by the port (which reads what "
                f"cv2.VideoWriter writes: {self.writes})")
        if rc == -2:
            raise MemoryError("fl_msmpeg4_decode: out of memory")
        if rc < 0:
            raise DecodeError(f"{self.what}: corrupt {self.name} packet")

    def decode(self, data: bytes) -> np.ndarray:
        """The packet's frame as BGR u8 (H, W, 3)."""
        data = bytes(data)
        self._check(_lib().fl_msmpeg4_decode(self._h, data, len(data)))
        out = np.empty((self.height, self.width, 3), np.uint8)
        if _lib().fl_msmpeg4_bgr(self._h, out.ctypes.data):
            raise MemoryError("fl_msmpeg4_bgr: out of memory")
        return out

    def planes(self):
        """The last frame's yuv420p planes (y, u, v), cropped to its size."""
        cw, ch = (self.width + 1) // 2, (self.height + 1) // 2
        y = np.empty((self.height, self.width), np.uint8)
        u = np.empty((ch, cw), np.uint8)
        v = np.empty((ch, cw), np.uint8)
        _lib().fl_msmpeg4_planes(self._h, y.ctypes.data, u.ctypes.data,
                                 v.ctypes.data)
        return y, u, v

    def counts(self) -> Dict[str, int]:
        """How often each syntax path (:attr:`paths`) was decoded."""
        out = np.zeros(len(C_PATHS), np.uint64)
        _lib().fl_msmpeg4_counts(self._h, out.ctypes.data)
        counts = dict(zip(C_PATHS, (int(v) for v in out)))
        return {k: counts[k] for k in self.paths}

    def close(self) -> None:
        if self._h:
            _lib().fl_msmpeg4_close(self._h)
            self._h = None

    def __del__(self):
        self.close()
