"""MPEG-4 Part 2 video as ``cv2.VideoCapture`` returns it (FFmpeg's
``mpeg4`` decoder, then swscale's yuv420p to BGR24), bit for bit, for
what ``cv2.VideoWriter`` writes with the fourccs ``mp4v``, ``MP4V``,
``XVID``, ``xvid``, ``FMP4``, ``DIVX``, ``DX50`` and ``GEOX`` (GeoVision's
tag, under which FFmpeg turns the pictures upside down: ``io/video`` flips
them): FFmpeg's own encoder,
I- and P-VOPs, 1MV, H.263 quantisation, user data ``Lavc...``.

Decoded on the host in C (``csrc/mpeg4_decode.c``, built at first use and
called through ctypes); a :class:`Mpeg4Decoder` keeps the VOL, the
reference frame and the prediction state across packets (a VOL repeated
in AVI, one in the extradata in MP4 and Matroska).  A tool no such stream
holds raises :class:`~fealess_tpu_torch.io.jpeg.UnsupportedImage` naming
it (:data:`REFUSED`), at open where the VOL in the extradata shows it,
else at the packet; a packet the decoder cannot read raises
:class:`~fealess_tpu_torch.io.png.DecodeError`.  A VOP that is not coded
(``vop_coded`` 0) gives no frame (:meth:`Mpeg4Decoder.decode` returns
None), as FFmpeg outputs none for it.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional

import numpy as np

from fealess_tpu_torch.io.jpeg import UnsupportedImage
from fealess_tpu_torch.io.png import DecodeError

# the codes of csrc/mpeg4_decode.c's M_* refusals
REFUSED = {
    1: "B-VOPs", 2: "S-VOPs (sprites, GMC)", 3: "quarter-pel motion",
    4: "interlaced video", 5: "MPEG quantisation (quant_type 1)",
    6: "4MV (INTER4V macroblocks)", 7: "resync markers",
    8: "data partitioning and RVLC",
    9: "the short video header (H.263 baseline)",
    10: "non-rectangular shape", 11: "not_8_bit",
    12: "Xvid's encoder (user data or fourcc; FFmpeg switches to the Xvid "
        "IDCT)",
    13: "DivX's encoder (user data or fourcc; FFmpeg applies its bug "
        "workarounds)",
    14: "an old libavcodec build (FFmpeg applies its bug workarounds)",
    15: "scalability", 16: "complexity estimation",
    17: "OBMC (obmc_disable 0)",
    18: "video_object_layer_verid above 1", 19: "DQUANT",
    20: "macroblock stuffing", 21: "intra_dc_vlc_thr other than 0",
    22: "a VOL that changes the frame size", 23: "the studio profile",
    24: "a video signal type (colour range) in the VO header",
    25: "a P-VOP before any I-VOP", 26: "VBV parameters",
    27: "an extended pixel aspect ratio", 28: "a fixed VOP rate",
    29: "AC prediction (ac_pred_flag 1)",
    30: "a DC difference of more than 8 bits (dct_dc_size 9)",
    31: "an odd frame height (cv2 converts it to BGR with MPEG-4's left "
        "chroma siting)"}
_REFUSED_BASE = 100

# csrc/mpeg4_decode.c's C_* syntax path counters, in order
PATHS = ("VOS", "VO", "VOL", "VOL_EXTRADATA", "USER_DATA", "GOV", "IVOP",
         "PVOP", "NOT_CODED_VOP", "I_MB", "P_INTRA_MB", "P_INTER_MB",
         "P_SKIP_MB", "INTRA_UNCODED_BLOCK", "INTER_CODED_BLOCK", "DC_ZERO",
         "DC_TOP", "DC_LEFT", "ESC1_INTRA", "ESC2_INTRA", "ESC3_INTRA",
         "ESC1_INTER", "ESC2_INTER", "ESC3_INTER", "ROUND0", "ROUND1",
         "FCODE1", "FCODE2UP", "MV_ZERO_CODE", "MV_CODED", "MC_FULL", "MC_X",
         "MC_Y", "MC_XY", "MC_CLAMPED")

# the fourccs cv2.VideoWriter writes MPEG-4 Part 2 for, and the upper-case
# ones FFmpeg's workarounds key on (h263dec takes codec_tag upper-cased)
FOURCCS = (b"mp4v", b"MP4V", b"XVID", b"xvid", b"FMP4", b"DIVX", b"DX50",
           b"GEOX", b"GEOV")
_XVID_TAGS = (b"XVID", b"XVIX", b"RMP4", b"ZMP4", b"SIPP")

_LIB = None
_LIB_LOCK = threading.Lock()


def _lib():
    """The host library (built at first use)."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from fealess_tpu_torch.ops import _build
            lib = ctypes.CDLL(str(_build.build_host("mpeg4_decode")))
            lib.fl_mpeg4_open.argtypes = (ctypes.c_char_p, ctypes.c_long,
                                          ctypes.c_int, ctypes.c_void_p)
            lib.fl_mpeg4_open.restype = ctypes.c_void_p
            lib.fl_mpeg4_decode.argtypes = (ctypes.c_void_p, ctypes.c_char_p,
                                            ctypes.c_long, ctypes.c_void_p)
            lib.fl_mpeg4_decode.restype = ctypes.c_int
            lib.fl_mpeg4_bgr.argtypes = (ctypes.c_void_p, ctypes.c_void_p)
            lib.fl_mpeg4_bgr.restype = ctypes.c_int
            lib.fl_mpeg4_planes.argtypes = (ctypes.c_void_p,) + \
                (ctypes.c_void_p,) * 3
            lib.fl_mpeg4_planes.restype = None
            lib.fl_mpeg4_counts.argtypes = (ctypes.c_void_p, ctypes.c_void_p)
            lib.fl_mpeg4_counts.restype = ctypes.c_int
            lib.fl_mpeg4_close.argtypes = (ctypes.c_void_p,)
            lib.fl_mpeg4_close.restype = None
            _LIB = lib
    return _LIB


def _tag(fourcc: bytes) -> int:
    """What FFmpeg's workarounds see in the container's fourcc: 1 for
    Xvid's, 2 for DIVX, else 0."""
    up = fourcc.upper()
    return 1 if up in _XVID_TAGS else 2 if up == b"DIVX" else 0


class Mpeg4Decoder:
    """One MPEG-4 Part 2 stream: the container's ``fourcc`` (as FFmpeg's
    codec_tag; b"" for none) and ``extradata`` (a VOL, or empty);
    :meth:`decode` takes its packets in order.  ``what`` and
    ``container`` (e.g. "AVI") go into the messages."""

    def __init__(self, extradata: bytes, fourcc: bytes = b"",
                 what: str = "<stream>", container: str = ""):
        self.what = what
        tag = f" ({fourcc.decode('latin-1')})" if fourcc else ""
        self.kind = (f"{container} with " if container else "") + \
            f"MPEG-4 Part 2 video{tag}"
        extradata = bytes(extradata)
        rc = ctypes.c_int()
        self._h = _lib().fl_mpeg4_open(extradata, len(extradata),
                                       _tag(fourcc), ctypes.byref(rc))
        if not self._h:
            raise MemoryError("fl_mpeg4_open: out of memory")
        self._check(rc.value)

    def _check(self, rc: int) -> None:
        if rc >= _REFUSED_BASE:
            tool = REFUSED.get(rc - _REFUSED_BASE, f"tool {rc}")
            raise UnsupportedImage(
                f"{self.what}: {self.kind} using {tool} is read by "
                f"cv2.VideoCapture but not by the port (which reads what "
                f"cv2.VideoWriter writes: I- and P-VOPs, 1MV, H.263 "
                f"quantisation)")
        if rc == -2:
            raise MemoryError("fl_mpeg4_decode: out of memory")
        if rc < 0:
            raise DecodeError(f"{self.what}: corrupt MPEG-4 Part 2 packet")

    def decode(self, data: bytes) -> Optional[np.ndarray]:
        """The packet's frame as BGR u8 (H, W, 3), or None for a VOP that
        is not coded."""
        data = bytes(data)
        wh = np.zeros(2, np.int32)
        rc = _lib().fl_mpeg4_decode(self._h, data, len(data),
                                    wh.ctypes.data)
        if rc == 1:
            return None
        self._check(rc)
        out = np.empty((int(wh[1]), int(wh[0]), 3), np.uint8)
        if _lib().fl_mpeg4_bgr(self._h, out.ctypes.data):
            raise MemoryError("fl_mpeg4_bgr: out of memory")
        return out

    def planes(self, width: int, height: int):
        """The last frame's yuv420p planes (y, u, v), cropped to its size."""
        cw, ch = (width + 1) // 2, (height + 1) // 2
        y = np.empty((height, width), np.uint8)
        u = np.empty((ch, cw), np.uint8)
        v = np.empty((ch, cw), np.uint8)
        _lib().fl_mpeg4_planes(self._h, y.ctypes.data, u.ctypes.data,
                               v.ctypes.data)
        return y, u, v

    def counts(self) -> Dict[str, int]:
        """How often each syntax path (:data:`PATHS`) was decoded."""
        out = np.zeros(len(PATHS), np.uint64)
        _lib().fl_mpeg4_counts(self._h, out.ctypes.data)
        return dict(zip(PATHS, (int(v) for v in out)))

    def close(self) -> None:
        if self._h:
            _lib().fl_mpeg4_close(self._h)
            self._h = None

    def __del__(self):
        self.close()
