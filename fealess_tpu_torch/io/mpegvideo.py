"""An MPEG video elementary stream (``.m2v``, ``.mpv``: what
``cv2.VideoWriter`` writes for MPEG-2 under those names) cut into packets
as FFmpeg's ``mpegvideo`` demuxer and parser cut it for the decoder under
``cv2.VideoCapture``; :class:`~fealess_tpu_torch.io.mpeg2.Mpeg2Decoder`
decodes them.

The stream has no container: its first bytes are a sequence header's
start code (``00 00 01 b3``, after any zero bytes).  :func:`packets` is
``ff_mpeg1_find_frame_end`` run over the whole stream: a packet runs from
its first byte through its picture's slices and ends at the next start
code that is not a slice's (a picture, a GOP or a sequence header, user
data), so the sequence and GOP headers go with the picture that follows
them; a sequence end code ends the packet it closes, and is part of it.
The rest of the stream after the last cut is the last packet.  A last
packet that holds no slice (a stream cut inside a picture's headers)
gives FFmpeg's decoder no frame; the reader leaves it out, and the
frames the decoder holds are drained after it as at the end of any
stream.

MPEG program and transport streams (:mod:`~fealess_tpu_torch.io.mpegps`,
:mod:`~fealess_tpu_torch.io.mpegts`) hand their video payload to the
same parsers: :func:`packets` for MPEG-2, and for MPEG-4 Part 2
:func:`mpeg4_packets`, FFmpeg's ``mpeg4video`` parser
(``ff_mpeg4_find_frame_end``): a packet runs through its VOP's start
code (``00 00 01 b6``) and ends at the next start code of any kind, so
the VOS, VOL, GOV and user data before a VOP go with it; the rest of the
stream is the last packet.  :func:`payload_codec` tells the two apart as
FFmpeg's probes do where the container names no codec.
"""

from __future__ import annotations

from typing import BinaryIO, Iterator, List, Optional, Tuple

_EXT, _SEQ, _SEQ_END = 0x1B5, 0x1B3, 0x1B7
_SLICE_MIN, _SLICE_MAX = 0x101, 0x1AF


def start_code_at(head: bytes) -> int:
    """The code of the start code the first bytes hold after any zero
    bytes (``00 00 01 xx``, two zeros or more), or -1."""
    body = head.lstrip(b"\0")
    if len(head) - len(body) < 2 or body[:1] != b"\x01" or len(body) < 2:
        return -1
    return body[1]


def is_mpeg_video(head: bytes) -> bool:
    """A sequence header's start code first, after any zero bytes."""
    return start_code_at(head) == 0xB3


def _is_slice(state: int) -> bool:
    return _SLICE_MIN <= state <= _SLICE_MAX


def find_start_code(data: bytes, i: int, end: int,
                    state: int) -> Tuple[int, int]:
    """``avpriv_find_start_code``: the index past the first start code
    (``00 00 01 xx``) from ``i``, with the 32 bits before ``i`` in
    ``state``, and the new state; ``end`` and the last four bytes' state
    where there is none."""
    if i >= end:
        return end, state
    for _ in range(3):
        tmp = (state << 8) & 0xFFFFFFFF
        state = tmp + data[i]
        i += 1
        if tmp == 0x100 or i == end:
            return i, state
    k = data.find(b"\x00\x00\x01", i - 3, end)
    if k < 0 or k + 4 > end:
        return end, int.from_bytes(data[end - 4:end], "big")
    return k + 4, 0x100 | data[k + 3]


def frame_end(data: bytes, start: int, end: int) -> Optional[int]:
    """``ff_mpeg1_find_frame_end`` from a fresh parser state at ``start``:
    where the packet that starts there ends, or None where the stream
    ends first."""
    state, found, i = 0xFFFFFFFF, 0, start
    while i < end:
        if found & 1:          # counting into a picture coding extension
            if state == _EXT and (data[i] & 0xF0) != 0x80:
                found -= 1
            elif state == _EXT + 2:
                found = 0 if data[i] & 3 == 3 else (found + 1) & 3
            state = (state + 1) & 0xFFFFFFFF
        else:
            p, state = find_start_code(data, i, end, state)
            i = p - 1
            if found == 0 and _is_slice(state):
                i += 1
                found = 4
            if state == _SEQ_END:
                return i + 1
            if found == 2 and state == _SEQ:
                found = 0
            if found < 4 and state == _EXT:
                found += 1
            if found == 4 and state & 0xFFFFFF00 == 0x100 and \
                    not _is_slice(state):
                return i - 3
        i += 1
    return None


def packets(data: bytes) -> List[bytes]:
    """The stream cut into the packets FFmpeg's parser hands the decoder
    (see the module docstring), the last one left out where it holds no
    slice."""
    out, at = [], 0
    while at < len(data):
        end = frame_end(data, at, len(data))
        if end is None:
            last = data[at:]
            if _has_slice(last):
                out.append(last)
            break
        out.append(data[at:end])
        at = end
    return out


def _has_slice(data: bytes) -> bool:
    at = data.find(b"\x00\x00\x01")
    while 0 <= at < len(data) - 3:
        if 0x01 <= data[at + 3] <= 0xAF:
            return True
        at = data.find(b"\x00\x00\x01", at + 3)
    return False


def mpeg4_packets(data: bytes) -> List[bytes]:
    """The MPEG-4 Part 2 stream ``data`` cut into the packets FFmpeg's
    ``mpeg4video`` parser hands the decoder (see the module
    docstring)."""
    out, at = [], 0
    while at < len(data):
        vop = data.find(b"\x00\x00\x01\xb6", at)
        end = -1 if vop < 0 else data.find(b"\x00\x00\x01", vop + 4)
        if end < 0 or end + 3 >= len(data):
            out.append(data[at:])
            break
        out.append(data[at:end])
        at = end
    return out


# the video codecs FFmpeg's probes find by a stream's first start code
# that the port does not decode, by name
_PROBED_NAMES = {0x09: "H.264", 0x67: "H.264", 0x27: "H.264",
                 0x47: "H.264", 0x40: "HEVC", 0x46: "HEVC"}


def payload_codec(data: bytes) -> Optional[str]:
    """The codec of a video payload whose container names none (an MPEG
    program stream's): ``"mpeg2"`` where it opens with a sequence header
    (FFmpeg's ``mpegvideo`` probe), ``"mpeg4"`` with a VOS, VO or VOL
    (its ``m4v`` probe), the name of another codec its probes find
    (H.264, HEVC) by its first NAL unit, or None where no probe takes it
    (cv2 then opens no video stream)."""
    code = start_code_at(data[:64])
    if code == 0xB3:
        return "mpeg2"
    if code in (0xB0, 0xB5) or 0x20 <= code <= 0x2F:
        return "mpeg4"
    if 0 <= code <= 0x1F:                # a VO start code, then its VOL
        at = data.find(b"\x00\x00\x01", data.find(b"\x00\x00\x01") + 4)
        if 0 <= at < len(data) - 3 and 0x20 <= data[at + 3] <= 0x2F:
            return "mpeg4"
    return _PROBED_NAMES.get(code)


class MpegVideoFile:
    """The MPEG video elementary stream at ``path``: :meth:`frames` gives
    its packets.  Close it (or use it as a context manager)."""

    def __init__(self, path: str):
        self.path = path
        self._f: BinaryIO = open(path, "rb")

    def frames(self) -> Iterator[bytes]:
        self._f.seek(0)
        yield from packets(self._f.read())

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "MpegVideoFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
