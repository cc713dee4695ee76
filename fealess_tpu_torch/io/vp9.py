"""VP9 video as ``cv2.VideoCapture`` returns it (FFmpeg's native ``vp9``
decoder, then swscale's yuv420p to BGR24), bit for bit: what
``cv2.VideoWriter`` writes with the fourcc ``VP90`` in AVI, Matroska and
WebM and with ``vp09`` in MP4 (libvpx: profile 0, key and inter frames,
golden refreshes, tiles, switchable interpolation filters), and the
header tools the committed clips re-encode (backward adaptation, kept and
chosen probability contexts, error resilience, loop-filter levels,
sharpness and deltas, quantiser indices and deltas, tile rows, the colour
range) or hand-build (superframes, hidden frames, ``show_existing_frame``).

Decoded on the host in C (``csrc/vp9_decode.c``, the VP9 Bitstream &
Decoding Process Specification; built at first use and called through
ctypes); a :class:`Vp9Decoder` keeps the eight reference slots, the four
saved probability contexts, the loop-filter deltas and the last frame's
motion vectors across packets.  :meth:`Vp9Decoder.decode` splits a
superframe (the specification's Annex B) and returns the frames its
packet shows, as FFmpeg's ``vp9_superframe_split`` and decoder give them
to cv2: none for a hidden frame, two for a superframe of two shown
frames.  A tool no committed clip holds raises
:class:`~fealess_tpu_torch.io.jpeg.UnsupportedImage` naming it
(:data:`REFUSED`); a packet FFmpeg rejects raises
:class:`~fealess_tpu_torch.io.png.DecodeError`.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Tuple

import numpy as np

from fealess_tpu_torch.io.jpeg import UnsupportedImage
from fealess_tpu_torch.io.png import DecodeError

# the codes of csrc/vp9_decode.c's R_* refusals
REFUSED = {
    1: "profile 1-3 (4:4:4, 4:2:2, 4:4:0, 10- or 12-bit)",
    2: "segmentation",
    3: "an intra-only frame",
    4: "compound prediction (reference sign biases that differ)",
    5: "a reference of another size (scaled motion compensation)",
    6: "a key frame that changes the frame size",
    7: "lossless coding (q index 0)",
    8: "a color_space cv2 converts with another matrix than BT.601 "
       "(BT.709, SMPTE 240M, BT.2020 or reserved)",
    9: "a frame wider or taller than 8192"}
_REFUSED_BASE = 100

# csrc/vp9_decode.c's C_* syntax path counters, in order
PATHS = ("KEY_FRAME", "INTER_FRAME", "HIDDEN_FRAME", "SHOW_EXISTING",
         "ERROR_RESILIENT", "RESET_CONTEXT", "CONTEXT_IDX",
         "NO_REFRESH_CONTEXT", "ADAPT", "FULL_RANGE", "RENDER_SIZE",
         "SIZE_FROM_REF", "HIGH_PRECISION_MV", "FILTER_SWITCHABLE",
         "FILTER_REGULAR", "FILTER_SMOOTH", "FILTER_SHARP",
         "FILTER_BILINEAR", "LF_DELTA_UPDATE", "LF_SHARPNESS", "LF_OFF",
         "DELTA_Q", "TILE_COLS", "TILE_ROWS", "TX_MODE_SELECT",
         "COEF_UPDATE", "MODE_UPDATE", "MV_UPDATE", "PREV_MVS",
         "PARTITION_NONE", "PARTITION_HORZ", "PARTITION_VERT",
         "PARTITION_SPLIT", "PARTITION_EDGE", "BLOCK_4X4", "BLOCK_4X8",
         "BLOCK_8X4", "SKIP", "TX_4X4", "TX_8X8", "TX_16X16", "TX_32X32",
         "INTRA_DC", "INTRA_V", "INTRA_H", "INTRA_D45", "INTRA_D135",
         "INTRA_D117", "INTRA_D153", "INTRA_D207", "INTRA_D63", "INTRA_TM",
         "INTRA_EDGE", "INTER_INTRA", "REF_LAST", "REF_GOLDEN", "REF_ALTREF",
         "NEARESTMV", "NEARMV", "ZEROMV", "NEWMV", "SUB8X8_NEAREST",
         "SUB8X8_NEAR", "SUB8X8_NEW", "MV_CLASS0", "MV_LONG", "MV_HP",
         "TOKEN_CAT1", "TOKEN_CAT2", "TOKEN_CAT3", "TOKEN_CAT4",
         "TOKEN_CAT5", "TOKEN_CAT6", "ADST", "MC_FULL", "MC_H", "MC_V",
         "MC_HV", "MC_EDGE", "LF_FILTER4", "LF_FILTER8", "LF_FILTER16")

# csrc/vp9_decode.c's T_* bool tags: the switchable interpolation filter's
# bools (read only with interp_filter SWITCHABLE), the MV high precision
# bits (read only with allow_high_precision_mv) and the bools that choose
# the golden or the altref reference
TAGS = {"filter": 1, "hp": 2, "golden_altref": 3}

# the AVI / VfW fourcc, the MP4 sample entry and the Matroska CodecID
# FFmpeg decodes as VP9
FOURCCS = (b"VP90",)
MP4_FOURCC = b"vp09"
CODEC_ID = "V_VP9"

_LIB = None
_LIB_LOCK = threading.Lock()


def _lib():
    """The host library (built at first use)."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from fealess_tpu_torch.ops import _build
            lib = ctypes.CDLL(str(_build.build_host("vp9_decode")))
            p, i, lng = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
            for name, args, res in (
                    ("fl_vp9_open", (), p),
                    ("fl_vp9_decode", (p, ctypes.c_char_p, lng, p), i),
                    ("fl_vp9_bgr", (p, p), i),
                    ("fl_vp9_planes", (p, p, p, p), None),
                    ("fl_vp9_counts", (p, p), None),
                    ("fl_vp9_npaths", (), i),
                    ("fl_vp9_trace_on", (p, lng), i),
                    ("fl_vp9_trace", (p, p, p, p, p, p, lng, p), None),
                    ("fl_vp9_replay", (p, p, lng, p, lng), None),
                    ("fl_vp9_close", (p,), None)):
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = args, res
            assert lib.fl_vp9_npaths() == len(PATHS)
            _LIB = lib
    return _LIB


def superframe(data: bytes) -> List[bytes]:
    """The frames of a packet: split by its superframe index (Annex B) as
    FFmpeg's ``vp9_superframe_split`` splits it, else the packet itself.
    Raises DecodeError where FFmpeg's filter fails the packet."""
    marker = data[-1] if data else 0
    if marker & 0xE0 != 0xC0:
        return [data]
    mag, count = ((marker >> 3) & 3) + 1, (marker & 7) + 1
    index = 2 + mag * count
    if len(data) < index or data[-index] != marker:
        return [data]
    out, pos = [], 0
    for k in range(count):
        at = len(data) - index + 1 + k * mag
        size = int.from_bytes(data[at:at + mag], "little")
        if size <= 0 or pos + size > len(data) - index:
            raise DecodeError("invalid frame size in a VP9 superframe")
        out.append(data[pos:pos + size])
        pos += size
    return out


class Vp9Decoder:
    """One VP9 stream; :meth:`decode` takes its packets in order.  ``path``
    and ``container`` (e.g. "AVI") go into the messages."""

    def __init__(self, path: str = "<stream>", container: str = ""):
        self.what = path
        self.kind = (f"{container} with " if container else "") + \
            "VP9 video"
        self.width = self.height = 0
        self._h = _lib().fl_vp9_open()
        if not self._h:
            raise MemoryError("fl_vp9_open: out of memory")

    def _check(self, rc: int) -> None:
        if rc >= _REFUSED_BASE:
            tool = REFUSED.get(rc - _REFUSED_BASE, f"tool {rc}")
            raise UnsupportedImage(
                f"{self.what}: {self.kind} using {tool} is read by "
                f"cv2.VideoCapture but not by the port (which reads VP9 "
                f"profile 0 without segmentation)")
        if rc == -2:
            raise MemoryError("fl_vp9_decode: out of memory")
        if rc < 0:
            raise DecodeError(f"{self.what}: corrupt VP9 packet")

    def decode_frame(self, data: bytes) -> bool:
        """Decode one frame (not a superframe); True if it is shown (then
        :meth:`bgr` and :meth:`planes` give it)."""
        data = bytes(data)
        wh = np.zeros(2, np.int32)
        rc = _lib().fl_vp9_decode(self._h, data, len(data), wh.ctypes.data)
        if rc == 1:
            return False
        self._check(rc)
        self.width, self.height = int(wh[0]), int(wh[1])
        return True

    def bgr(self) -> np.ndarray:
        """The last shown frame as BGR u8 (H, W, 3)."""
        out = np.empty((self.height, self.width, 3), np.uint8)
        if _lib().fl_vp9_bgr(self._h, out.ctypes.data):
            raise MemoryError("fl_vp9_bgr: out of memory")
        return out

    def decode(self, data: bytes) -> List[np.ndarray]:
        """The frames the packet shows, as BGR u8 (H, W, 3), in order."""
        out = []
        for frame in superframe(bytes(data)):
            if self.decode_frame(frame):
                out.append(self.bgr())
        return out

    def planes(self):
        """The last shown frame's yuv420p planes (y, u, v), cropped to its
        size."""
        w, h = self.width, self.height
        y = np.empty((h, w), np.uint8)
        u = np.empty(((h + 1) // 2, (w + 1) // 2), np.uint8)
        v = np.empty_like(u)
        _lib().fl_vp9_planes(self._h, y.ctypes.data, u.ctypes.data,
                             v.ctypes.data)
        return y, u, v

    def counts(self) -> Dict[str, int]:
        """How often each syntax path (:data:`PATHS`) was decoded."""
        out = np.zeros(len(PATHS), np.uint64)
        _lib().fl_vp9_counts(self._h, out.ctypes.data)
        return dict(zip(PATHS, (int(v) for v in out)))

    def trace(self, cap: int = 1 << 22) -> None:
        """Keep the bools each later frame's partitions decode, up to
        ``cap`` (for the tests, which re-encode a stream with a header
        field or the tiling changed)."""
        if _lib().fl_vp9_trace_on(self._h, cap):
            raise MemoryError("fl_vp9_trace_on: out of memory")

    def traced(self) -> Tuple[np.ndarray, ...]:
        """The last frame's (probabilities, bits, tags, partition starts,
        superblock marks): the compressed header is partition 0, the tiles
        follow in order; a tag (:data:`TAGS`) names the bools a header
        field decides are read."""
        n = np.zeros(3, np.int64)
        _lib().fl_vp9_trace(self._h, None, None, None, None, None, 0,
                            n.ctypes.data)
        cap = int(max(n))
        prob, bit, tag = (np.empty(cap, np.uint8) for _ in range(3))
        part, mark = np.empty(cap, np.int64), np.empty(cap, np.int64)
        _lib().fl_vp9_trace(self._h, prob.ctypes.data, bit.ctypes.data,
                            tag.ctypes.data, part.ctypes.data,
                            mark.ctypes.data, cap, n.ctypes.data)
        return (prob[:n[0]], bit[:n[0]], tag[:n[0]], part[:n[1]],
                mark[:n[2]])

    def replay(self, data: bytes, bits: np.ndarray,
               parts: np.ndarray) -> bool:
        """:meth:`decode_frame` ``data`` (its uncompressed header) with its
        partitions' bits replaced by ``bits`` (partition k from
        ``parts[k]``); :meth:`traced` then gives the probabilities each bit
        was read with.  Needs :meth:`trace`."""
        bits = np.ascontiguousarray(bits, np.uint8)
        parts = np.ascontiguousarray(parts, np.int64)
        _lib().fl_vp9_replay(self._h, bits.ctypes.data, len(bits),
                             parts.ctypes.data, len(parts))
        try:
            return self.decode_frame(data)
        finally:
            _lib().fl_vp9_replay(self._h, None, 0, None, 0)

    def close(self) -> None:
        if getattr(self, "_h", None) and _LIB is not None:
            _LIB.fl_vp9_close(self._h)
        self._h = None

    def __del__(self):
        self.close()
