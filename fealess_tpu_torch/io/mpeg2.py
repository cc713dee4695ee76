"""MPEG-2 video as ``cv2.VideoCapture`` returns it (FFmpeg's
``mpeg2video`` decoder, then swscale's yuv420p to BGR24), bit for bit,
for what ``cv2.VideoWriter`` writes with the fourccs ``MPG2``, ``MPEG``
and ``mpg2``: FFmpeg's own encoder, progressive 4:2:0 frame pictures, I, P
and B pictures, default matrices, the linear quantiser scale.

Decoded on the host in C (``csrc/mpeg2_decode.c``, built at first use and
called through ctypes); a :class:`Mpeg2Decoder` keeps the sequence, the
two anchor pictures and the output order across packets.  FFmpeg outputs
an I or P picture one anchor late and a B picture at once, so
:meth:`Mpeg2Decoder.decode` returns the frames a packet releases (none,
or one) and :meth:`Mpeg2Decoder.flush` the last anchor at the end of the
stream.  A B picture whose forward reference is missing is dropped after
an open GOP, as FFmpeg drops it (a clip cut before an open GOP), and
predicted from a grey picture after a closed one.  A tool no such stream
holds raises :class:`~fealess_tpu_torch.io.jpeg.UnsupportedImage` naming
it (:data:`REFUSED`); a packet the decoder cannot read, or cut short,
raises :class:`~fealess_tpu_torch.io.png.DecodeError` (FFmpeg conceals
the macroblocks it lacks, which no reader can match).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List

import numpy as np

from fealess_tpu_torch.io.jpeg import UnsupportedImage
from fealess_tpu_torch.io.png import DecodeError

# the codes of csrc/mpeg2_decode.c's R_* refusals
REFUSED = {
    1: "field pictures", 2: "an interlaced sequence (progressive_sequence 0)",
    3: "field and dual-prime motion or field DCT (frame_pred_frame_dct 0)",
    4: "4:2:2 chroma", 5: "4:4:4 chroma",
    6: "intra_dc_precision above 8 bits",
    7: "the non-linear quantiser scale (q_scale_type 1)",
    8: "the intra VLC of table B-15 (intra_vlc_format 1)",
    9: "the alternate scan", 10: "concealment motion vectors",
    11: "a scalable extension", 12: "D pictures",
    13: "MPEG-1 (a sequence header without a sequence extension)",
    14: "a sequence header that changes the frame size or aspect ratio",
    15: "an odd frame height (cv2 converts it to BGR with MPEG-2's left "
        "chroma siting)",
    16: "a colour matrix other than BT.601's (sequence display extension)",
    17: "TMPGEnc's user data (FFmpeg changes the intra DC precision)",
    18: "a motion vector that reaches outside the picture (FFmpeg leaves "
        "that prediction out)",
    19: "several pictures in one packet",
    20: "a P or B picture without its reference picture",
    21: "a picture without a picture coding extension",
    22: "a packet that holds no picture"}
_REFUSED_BASE = 100

# csrc/mpeg2_decode.c's C_* syntax path counters, in order
PATHS = ("SEQ", "SEQ_EXTRADATA", "SEQ_EXT", "DISPLAY_EXT", "MATRIX_LOADED",
         "QUANT_MATRIX_EXT", "OTHER_EXT", "GOP_CLOSED", "GOP_OPEN",
         "BROKEN_LINK", "USER_DATA", "SEQ_END", "I_PIC", "P_PIC", "B_PIC",
         "B_DROPPED", "GREY_FORWARD", "DRAIN", "LOW_DELAY", "SLICE",
         "SLICE_EXTRA", "MB_ESCAPE", "I_MB", "I_MB_QUANT", "P_INTRA",
         "P_FORWARD", "P_FORWARD_NOT_CODED", "P_ZERO_MV", "P_QUANT",
         "P_SKIP", "B_INTRA", "B_FORWARD", "B_BACKWARD", "B_BIDIR",
         "B_NOT_CODED", "B_QUANT", "B_SKIP", "DC_ZERO", "DC_CODED",
         "ESCAPE_INTRA", "ESCAPE_INTER", "EOB_AT_ONCE", "FIRST_ONE",
         "MISMATCH", "Q_FINE", "Q_COARSE", "FCODE1", "FCODE2UP",
         "MV_ZERO_CODE", "MV_CODED", "MC_FULL", "MC_X", "MC_Y", "MC_XY",
         "MC_AVG")

# the AVI fourccs of MPEG-2 that cv2.VideoWriter writes (MPG2 and mpg2
# give mpg2), which FFmpeg's AVI demuxer maps to mpeg2video
FOURCCS = (b"mpg2", b"MPEG")
CODEC_ID = "V_MPEG2"

_LIB = None
_LIB_LOCK = threading.Lock()


def _lib():
    """The host library (built at first use)."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from fealess_tpu_torch.ops import _build
            lib = ctypes.CDLL(str(_build.build_host("mpeg2_decode")))
            lib.fl_mpeg2_open.argtypes = (ctypes.c_char_p, ctypes.c_long,
                                          ctypes.c_void_p)
            lib.fl_mpeg2_open.restype = ctypes.c_void_p
            lib.fl_mpeg2_decode.argtypes = (ctypes.c_void_p, ctypes.c_char_p,
                                            ctypes.c_long, ctypes.c_void_p)
            lib.fl_mpeg2_decode.restype = ctypes.c_int
            lib.fl_mpeg2_bgr.argtypes = (ctypes.c_void_p, ctypes.c_void_p)
            lib.fl_mpeg2_bgr.restype = ctypes.c_int
            lib.fl_mpeg2_planes.argtypes = (ctypes.c_void_p,) + \
                (ctypes.c_void_p,) * 3
            lib.fl_mpeg2_planes.restype = None
            lib.fl_mpeg2_counts.argtypes = (ctypes.c_void_p, ctypes.c_void_p)
            lib.fl_mpeg2_counts.restype = ctypes.c_int
            lib.fl_mpeg2_close.argtypes = (ctypes.c_void_p,)
            lib.fl_mpeg2_close.restype = None
            _LIB = lib
    return _LIB


class Mpeg2Decoder:
    """One MPEG-2 video stream: the container's ``extradata`` (a sequence
    header, or empty); :meth:`decode` takes its packets in order and
    :meth:`flush` ends it.  ``what`` and ``container`` (e.g. "AVI") go into
    the messages."""

    def __init__(self, extradata: bytes = b"", what: str = "<stream>",
                 container: str = ""):
        self.what = what
        self.kind = (f"{container} with " if container else "") + \
            "MPEG-2 video"
        self.size = (0, 0)
        self._h = None
        extradata = bytes(extradata)
        rc = ctypes.c_int()
        self._lib = _lib()         # kept for close() at interpreter exit
        self._h = self._lib.fl_mpeg2_open(extradata, len(extradata),
                                          ctypes.byref(rc))
        if not self._h:
            raise MemoryError("fl_mpeg2_open: out of memory")
        self._check(rc.value)

    def _check(self, rc: int) -> None:
        if rc >= _REFUSED_BASE:
            tool = REFUSED.get(rc - _REFUSED_BASE, f"tool {rc}")
            raise UnsupportedImage(
                f"{self.what}: {self.kind} using {tool} is read by "
                f"cv2.VideoCapture but not by the port (which reads what "
                f"cv2.VideoWriter writes: progressive 4:2:0 frame pictures)")
        if rc == -2:
            raise MemoryError("fl_mpeg2_decode: out of memory")
        if rc < 0:
            raise DecodeError(f"{self.what}: corrupt MPEG-2 packet")

    def _run(self, data: bytes) -> List[np.ndarray]:
        wh = np.zeros(2, np.int32)
        rc = self._lib.fl_mpeg2_decode(self._h, data, len(data),
                                       wh.ctypes.data)
        if rc == 1:
            return []
        self._check(rc)
        self.size = (int(wh[0]), int(wh[1]))
        out = np.empty((self.size[1], self.size[0], 3), np.uint8)
        if self._lib.fl_mpeg2_bgr(self._h, out.ctypes.data):
            raise MemoryError("fl_mpeg2_bgr: out of memory")
        return [out]

    def decode(self, data: bytes) -> List[np.ndarray]:
        """The frames (BGR u8, (H, W, 3)) the packet releases: none or
        one."""
        return self._run(bytes(data))

    def flush(self) -> List[np.ndarray]:
        """The frames left at the end of the stream: the last anchor, if
        one is held."""
        return self._run(b"")

    def planes(self):
        """The planes (y, u, v) of the frame the last call returned,
        cropped to its size."""
        width, height = self.size
        cw, ch = (width + 1) // 2, (height + 1) // 2
        y = np.empty((height, width), np.uint8)
        u = np.empty((ch, cw), np.uint8)
        v = np.empty((ch, cw), np.uint8)
        self._lib.fl_mpeg2_planes(self._h, y.ctypes.data, u.ctypes.data,
                                  v.ctypes.data)
        return y, u, v

    def counts(self) -> Dict[str, int]:
        """How often each syntax path (:data:`PATHS`) was decoded."""
        out = np.zeros(len(PATHS), np.uint64)
        self._lib.fl_mpeg2_counts(self._h, out.ctypes.data)
        return dict(zip(PATHS, (int(v) for v in out)))

    def close(self) -> None:
        if self._h:
            self._lib.fl_mpeg2_close(self._h)
            self._h = None

    def __del__(self):
        self.close()
