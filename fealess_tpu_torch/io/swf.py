"""An SWF demuxer (``.swf``): the video packets as FFmpeg's ``swf``
demuxer hands them to the decoder under ``cv2.VideoCapture``, for
Sorenson Spark (what ``cv2.VideoWriter`` writes for ``FLV1`` there).

- The header: ``FWS``, the version and the file length, the frame RECT
  (its first five bits give the bits of each of its four fields), the
  frame rate (8.8 fixed point) and the frame count.
- Tags: a 16-bit little-endian code and length (the low six bits; 0x3F
  means a 32-bit length follows).  DefineVideoStream (60) makes a video
  stream: its character id, frame count, width, height, flags and codec
  id (2 is Sorenson Spark, FFmpeg's ``ff_swf_codec_tags``); VideoFrame
  (61) of a stream so made gives its data past the stream id and frame
  number as one packet, the bytes it has where the file ends inside it;
  ShowFrame, End and every other tag are skipped.

A compressed SWF (``CWS``) raises :class:`UnsupportedSwf`: FFmpeg inflates
it through ``zlib_refill``, which drops what ``inflate`` returns with the
stream's end and loses output when ``inflate`` fills the buffer without
asking for more input, so cv2 reads damaged frames from it, or none.  An
LZMA one (``ZWS``) raises :class:`SwfError`: FFmpeg's probe and header
reader take ``FWS`` and ``CWS`` only, and cv2 does not open it.  So does
a file with no DefineVideoStream tag (no video stream).  A codec id other
than 2 (VP6, Screen Video, ...), bitmap tags (which FFmpeg turns into
video streams of their own) and a second video stream raise
:class:`UnsupportedSwf`.
"""

from __future__ import annotations

import struct
from typing import Iterator, List

_DEFINE_VIDEO_STREAM, _VIDEO_FRAME = 60, 61
# DefineBitsLossless, DefineBitsJPEG2 and DefineBitsLossless2: FFmpeg
# makes a video stream of each
_BITMAP_TAGS = (20, 21, 36)
_SORENSON = 2
CODEC_NAMES = {3: "Screen Video", 4: "VP6", 5: "VP6 with alpha",
               6: "Screen Video 2"}


class SwfError(ValueError):
    """An SWF file cv2 does not open: the message says why."""


class UnsupportedSwf(ValueError):
    """An SWF file cv2 reads and the port does not: the message names
    what."""


def is_swf(head: bytes) -> bool:
    return head[:3] in (b"FWS", b"CWS", b"ZWS")


class SwfFile:
    """The video stream of the SWF file at ``path``: :attr:`codec`
    (``"flv1"``), its :attr:`width` and :attr:`height` as
    DefineVideoStream gives them, and :meth:`frames`."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            data = f.read()
        if data[:3] == b"CWS":
            raise UnsupportedSwf(
                f"{path}: a compressed SWF (CWS), which FFmpeg's swf "
                f"demuxer inflates losing bytes (cv2 reads damaged frames "
                f"from it, or none)")
        if data[:3] != b"FWS" or len(data) < 9:
            raise SwfError(f"{path}: not an SWF FFmpeg reads (FWS)")
        nbits = data[8] >> 3
        at = 9 + (4 * nbits - 3 + 7) // 8 + 4    # RECT, rate, frame count
        self._frames: List[bytes] = []
        stream = None
        self.codec = ""
        self.width = self.height = 0
        while at + 2 <= len(data):
            code = struct.unpack_from("<H", data, at)[0]
            kind, size = code >> 6, code & 0x3F
            at += 2
            if size == 0x3F:
                if at + 4 > len(data):
                    break
                size = struct.unpack_from("<i", data, at)[0]
                at += 4
            body = data[at:at + max(size, 0)]
            at += max(size, 0)
            if kind in _BITMAP_TAGS:
                raise UnsupportedSwf(f"{path}: an SWF with bitmap tags "
                                     f"(FFmpeg makes video streams of them)")
            if kind == _DEFINE_VIDEO_STREAM and len(body) >= 10:
                cid = struct.unpack_from("<H", body)[0]
                if cid == stream:
                    continue
                if stream is not None:
                    raise UnsupportedSwf(f"{path}: an SWF with several video "
                                         f"streams")
                codec = body[9]
                if codec != _SORENSON:
                    name = CODEC_NAMES.get(codec, f"codec id {codec}")
                    raise UnsupportedSwf(f"{path}: SWF with {name} video")
                stream, self.codec = cid, "flv1"
                self.width, self.height = struct.unpack_from("<HH", body, 4)
            elif kind == _VIDEO_FRAME and stream is not None and \
                    len(body) > 4 and \
                    struct.unpack_from("<H", body)[0] == stream:
                self._frames.append(body[4:])
        if stream is None:
            raise SwfError(f"{path}: an SWF with no video stream")

    def frames(self) -> Iterator[bytes]:
        yield from self._frames

    def close(self) -> None:
        """Nothing to release: the file was read whole at open."""
