"""An MPEG program stream demuxer (``.mpg``, ``.mpeg``, ``.vob``): the
packets of its first video stream as FFmpeg's ``mpeg`` demuxer and its
video parser hand them to the decoder under ``cv2.VideoCapture``.

The demuxer walks the file from start code to start code (``00 00 01
xx``) as ``mpegps_read_pes_header`` does, so it takes pack headers of
both forms (MPEG-1's ``0010`` marker, MPEG-2's ``01`` marker with pack
stuffing) and the system header by skipping past their start codes, and
the end code (``b9``) likewise:

- padding (``be``) and private stream 2 (``bf``) are skipped by their
  length;
- a PES packet of a video (``e0``-``ef``), audio (``c0``-``df``) or
  private stream 1 (``bd``) has a header of either form: MPEG-1's (0xFF
  stuffing, the STD buffer, a PTS or a PTS and a DTS, else ``0x0F``) or
  MPEG-2's (flags and a header length); a header that does not parse is
  passed over as FFmpeg resyncs there;
- the payloads of the first video stream, joined, are the stream; a PES
  packet cut short by the end of the file gives the bytes it has.

The stream names no codec: FFmpeg probes it (:func:`~fealess_tpu_torch.
io.mpegvideo.payload_codec`).  MPEG-2 is cut into pictures by
:func:`~fealess_tpu_torch.io.mpegvideo.packets` as the ``.m2v`` reader
cuts it, MPEG-4 Part 2 at its VOPs by :func:`~fealess_tpu_torch.io.
mpegvideo.mpeg4_packets`.  A file with no video stream, or one no probe
takes (what ``cv2.VideoWriter`` writes for Motion JPEG, FFV1, raw video,
VP8, ... in ``.mpg``), raises :class:`MpegPsError`, as cv2 does not open
it; a program stream map (``bc``, which the writer never writes and
FFmpeg reads stream types from) and the codecs the probes find that the
port does not decode raise :class:`UnsupportedMpegPs`.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

from fealess_tpu_torch.io.mpegvideo import (mpeg4_packets, packets,
                                            payload_codec, start_code_at)

_PACK, _MAP, _PADDING, _PRIVATE_2 = 0xBA, 0xBC, 0xBE, 0xBF
_PRIVATE_1 = 0xBD


class MpegPsError(ValueError):
    """A program stream cv2 does not open: the message says why."""


class UnsupportedMpegPs(ValueError):
    """A program stream cv2 reads and the port does not: the message
    names what."""


def is_mpeg_ps(head: bytes) -> bool:
    """A pack header's start code first, after any zero bytes."""
    return start_code_at(head) == _PACK


def pes_header(data: bytes, at: int, length: int) -> Optional[int]:
    """The payload's offset in the PES packet whose body (past its length
    field) starts at ``at`` and holds ``length`` bytes, by either header
    form, or None where the header does not parse (FFmpeg resyncs)."""
    end = at + length
    while True:                                   # MPEG-1 stuffing
        if at >= end or at >= len(data):
            return None
        c = data[at]
        at += 1
        if c != 0xFF:
            break
    if c & 0xC0 == 0x40:                          # STD buffer scale, size
        if at + 2 > len(data):
            return None
        c = data[at + 1]
        at += 2
    if c & 0xE0 == 0x20:                          # PTS, or PTS and DTS
        at += 4 + (5 if c & 0x10 else 0)
    elif c & 0xC0 == 0x80:                        # MPEG-2
        if at + 2 > len(data):
            return None
        header_len = data[at + 1]
        at += 2
        if at + header_len > end:
            return None
        at += header_len
    elif c != 0x0F:
        return None
    return at if at <= end else None


def video_payload(data: bytes, path: str) -> Tuple[int, bytes]:
    """(stream id, joined payload) of the first video stream of the
    program stream ``data``; stream id -1 where it has none."""
    sid, parts, at = -1, [], 0
    while True:
        k = data.find(b"\x00\x00\x01", at)
        if k < 0 or k + 4 > len(data):
            break
        code, at = data[k + 3], k + 4
        if code == _MAP:
            raise UnsupportedMpegPs(f"{path}: an MPEG program stream with a "
                                    f"program stream map")
        if code in (_PADDING, _PRIVATE_2):
            if at + 2 <= len(data):
                at += 2 + int.from_bytes(data[at:at + 2], "big")
            continue
        if not (0xC0 <= code <= 0xEF or code in (_PRIVATE_1, 0xFD)):
            continue                      # packs, system header, end code
        if at + 2 > len(data):
            break
        length = int.from_bytes(data[at:at + 2], "big")
        body = at + 2
        start = pes_header(data, body, length)
        if start is None:
            continue                      # resync after the start code
        end = body + length
        if code >= 0xE0 and sid in (-1, code):
            sid = code
            parts.append(data[start:end])
        at = end
    return sid, b"".join(parts)


class MpegPsFile:
    """The first video stream of the program stream at ``path``:
    :attr:`codec` (``"mpeg2"`` or ``"mpeg4"``) and :meth:`frames`."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            data = f.read()
        sid, self._payload = video_payload(data, path)
        if sid < 0:
            raise MpegPsError(f"{path}: an MPEG program stream with no "
                              f"video stream")
        codec = payload_codec(self._payload)
        if codec is None:
            raise MpegPsError(f"{path}: no codec FFmpeg's probes find in "
                              f"the video stream {sid:#x}")
        if codec not in ("mpeg2", "mpeg4"):
            raise UnsupportedMpegPs(f"{path}: an MPEG program stream with "
                                    f"{codec} video")
        self.codec = codec
        self.width = self.height = 0       # the decoder's, from the stream

    def frames(self) -> Iterator[bytes]:
        split = packets if self.codec == "mpeg2" else mpeg4_packets
        yield from split(self._payload)

    def close(self) -> None:
        """Nothing to release: the file was read whole at open."""
