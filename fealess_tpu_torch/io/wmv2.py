"""WMV8 video as ``cv2.VideoCapture`` returns it (FFmpeg's ``wmv2``
decoder, then swscale's yuv420p to BGR24), bit for bit, for what
``cv2.VideoWriter`` writes with the fourcc ``WMV2``: FFmpeg's own wmv2
encoder, I and P pictures, one slice and one quantiser a picture, 8x8
transforms, no AC prediction, no IntraX8, no mspel motion compensation,
no loop filter and no skipped macroblocks.  The stream carries no picture
size, the container's is the decoder's; its settings are the container's
4-byte extradata (FFmpeg's ``decode_ext_header``).

Decoded on the host in C by the MS MPEG-4 decoder (``csrc/
msmpeg4_decode.c``'s version 5: WMV8's picture headers, its P pictures'
CBP tables chosen by qscale band, its own inverse transform, on the
macroblock, block and run/level code of MS MPEG-4 v3 and WMV7, with the
tables of ``csrc/msmpeg4_tables.h``), built at first use and called
through ctypes; a :class:`WMV2Decoder` keeps the reference picture, the
vectors and the rounding state across packets.  A tool no such stream
holds raises :class:`~fealess_tpu_torch.io.jpeg.UnsupportedImage` naming
it (:data:`REFUSED`); a packet the decoder cannot read raises
:class:`~fealess_tpu_torch.io.png.DecodeError`.
"""

from __future__ import annotations

from fealess_tpu_torch.io import msmpeg4

# the codes of csrc/msmpeg4_decode.c's R_* refusals a WMV8 stream meets
REFUSED = {
    1: "AC prediction", 2: "a run/level table chosen per macroblock",
    3: "a slice code other than one slice",
    4: "a P picture before any I picture", 5: "DC table 0",
    6: "MV table 0", 8: "IntraX8 (j_type) I pictures",
    9: "mspel motion compensation", 10: "ABT 8x4 / 4x8 transforms",
    11: "the loop filter", 12: "skipped macroblocks (a skip type)",
    13: "the top-left MV flag", 14: "no 4-byte extension header"}

# the syntax paths (csrc/msmpeg4_decode.c's C_* counters) a WMV8 stream
# can take: MS MPEG-4's but the skip flags and WMV7's inter-intra
# prediction, and the P pictures' three CBP tables
PATHS = tuple(p for p in msmpeg4.PATHS
              if p not in ("P_SKIP_MB", "INTER_INTRA")) + \
    ("CBP_TABLE0", "CBP_TABLE1", "CBP_TABLE2")
# FFmpeg's decoder (the port's codec name) and the AVI fourcc it maps to it
FOURCCS = {"wmv2": (b"WMV2",)}
NAME = "WMV8"
VERSION = 5                    # csrc/msmpeg4_decode.c's version for WMV8


def codec_of(fourcc: bytes) -> str:
    """``"wmv2"`` for the fourcc FFmpeg decodes as WMV8, else ""."""
    return "wmv2" if fourcc in FOURCCS["wmv2"] else ""


class WMV2Decoder(msmpeg4.MSMPEG4Decoder):
    """One WMV8 stream of ``width`` x ``height`` pictures (the
    container's) whose settings are ``extradata`` (the container's: AVI's
    ``strf`` tail, ASF's and NUT's codec data, Matroska's
    BITMAPINFOHEADER tail, MOV's ``glbl``); :meth:`decode` takes its
    packets in order.  The container's ``fourcc`` (b"" for none),
    ``what`` and ``container`` (e.g. "AVI") go into the messages."""

    refused = REFUSED
    paths = PATHS
    writes = ("I and P pictures, one slice, 8x8 transforms, no AC "
              "prediction, IntraX8, mspel, loop filter or skipped "
              "macroblocks")

    def __init__(self, extradata: bytes, width: int, height: int,
                 fourcc: bytes = b"", what: str = "<stream>",
                 container: str = ""):
        self._h = None
        self.codec = "wmv2"
        self._open(VERSION, NAME, width, height, fourcc, what, container)
        extradata = bytes(extradata)
        self._check(msmpeg4._lib().fl_msmpeg4_ext_header(
            self._h, extradata, len(extradata)))
