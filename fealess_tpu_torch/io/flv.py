"""An FLV demuxer (``.flv``): the video packets as FFmpeg's ``flv``
demuxer hands them to the decoder under ``cv2.VideoCapture``, for VP9 in
enhanced FLV (what ``cv2.VideoWriter`` writes for ``VP90`` there) and
Sorenson Spark in legacy tags (what it writes for ``FLV1`` and ``s263``).

- The header (``FLV``, version, flags, the data offset), then after the
  first PreviousTagSize each tag: its type (8 audio, 9 video, 18 script
  data; the others skipped), data size, timestamp and stream id, its
  data and the PreviousTagSize after it, which must match the tag (where
  it does not, FFmpeg drops the tag and resyncs: :class:`UnsupportedFlv`
  names it, as it names a tag of the filter (encrypted) bit); a tag cut
  short by the end of the file gives the bytes it has, as FFmpeg's
  ``av_get_packet`` does.
- Video tags in the enhanced form (the ExHeader bit of the first byte, a
  FourCC after it): packet type SequenceStart (``vpcC``, the codec
  configuration), SequenceEnd, Metadata (AMF ``colorInfo``) and frame
  type 5 (a command frame) give no frame; CodedFrames and CodedFramesX
  give one packet each, which :class:`~fealess_tpu_torch.io.vp9.
  Vp9Decoder` splits by its superframe index as in WebM.  A FourCC other
  than ``vp09`` (AV1, HEVC, H.264) and multitrack packets are refused by
  name.
- Video tags in the legacy form carry the codec id in the low nibble of
  the first byte and the frame type in the high one: Sorenson Spark (id
  2) gives the tag's data past that byte as its packet, whatever the
  frame type says (FFmpeg's decoder takes the picture type from the
  picture header); every other legacy codec (VP6, H.264, ...) is refused
  by its name.

A file with no video tag raises :class:`FlvError` (cv2 opens no video
stream in it).
"""

from __future__ import annotations

from typing import Iterator, List

# enhanced FLV's packet types that carry frames (CodedFrames,
# CodedFramesX), its multitrack type, and the command frame type
_CODED, _CODED_X, _MULTITRACK, _COMMAND_FRAME = 1, 3, 6, 5
# the legacy codec id of Sorenson Spark (FFmpeg's FLV_CODECID_H263)
_SORENSON = 2
# FourCCs of enhanced FLV and the legacy codec ids: their names
FOURCC_NAMES = {b"vp09": "vp9", b"av01": "AV1", b"hvc1": "HEVC",
                b"avc1": "H.264", b"vp08": "VP8"}
LEGACY_NAMES = {3: "Flash Screen Video", 4: "VP6",
                5: "VP6 with alpha", 6: "Flash Screen Video 2", 7: "H.264",
                12: "HEVC"}


class FlvError(ValueError):
    """An FLV file cv2 does not open: the message says why."""


class UnsupportedFlv(ValueError):
    """An FLV file cv2 reads and the port does not: the message names
    what."""


def is_flv(head: bytes) -> bool:
    return head[:3] == b"FLV"


class FlvFile:
    """The video stream of the FLV file at ``path``: :attr:`codec`
    (``"vp9"`` or ``"flv1"``) and :meth:`frames`."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            data = f.read()
        self._frames: List[bytes] = []
        codec = None
        at = int.from_bytes(data[5:9], "big") + 4   # past PreviousTagSize0
        while at + 11 <= len(data):
            kind, size = data[at], int.from_bytes(data[at + 1:at + 4], "big")
            body = data[at + 11:at + 11 + size]
            last = data[at + 11 + size:at + 15 + size]
            at += 11 + size + 4
            if len(last) == 4 and int.from_bytes(last, "big") not in (
                    size + 11, size + 10, size):
                raise UnsupportedFlv(f"{path}: an FLV PreviousTagSize that "
                                     f"does not match its tag (FFmpeg "
                                     f"resyncs there)")
            if kind & 0x20:
                raise UnsupportedFlv(f"{path}: an encrypted FLV tag")
            if kind & 0x1F != 9 or not body:
                continue
            name, frame = self._video_tag(body)
            codec = codec or name
            if name != codec:
                raise UnsupportedFlv(f"{path}: FLV video whose codec changes "
                                     f"({codec}, then {name})")
            if frame is not None:
                self._frames.append(frame)
        if codec is None:
            raise FlvError(f"{path}: an FLV file with no video tag")
        if codec not in ("vp9", "flv1"):
            raise UnsupportedFlv(f"{path}: FLV with {codec} video")
        self.codec = codec
        self.width = self.height = 0       # the decoder's, from the stream

    def _video_tag(self, body: bytes):
        """(codec, the frame or None) of a video tag's data."""
        flags = body[0]
        if not flags & 0x80:                      # legacy
            cid = flags & 0x0F
            if cid == _SORENSON:
                return "flv1", body[1:]
            return LEGACY_NAMES.get(cid, f"codec id {cid}"), None
        kind = flags & 0x0F
        if kind == _MULTITRACK:
            raise UnsupportedFlv(f"{self.path}: a multitrack FLV video tag")
        fourcc = body[1:5]
        codec = FOURCC_NAMES.get(fourcc, f"FourCC {fourcc!r}")
        if (flags >> 4) & 7 == _COMMAND_FRAME or \
                kind not in (_CODED, _CODED_X):
            return codec, None
        return codec, body[5:]

    def frames(self) -> Iterator[bytes]:
        yield from self._frames

    def close(self) -> None:
        """Nothing to release: the file was read whole at open."""
