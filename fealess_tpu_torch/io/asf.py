"""An ASF demuxer (``.asf``, ``.wmv``): the media objects of its first
video stream as FFmpeg's ``asf`` demuxer (``asfdec_f``) hands them to the
decoder under ``cv2.VideoCapture``.

- The Header Object: File Properties give the packet size (its minimum,
  which ``cv2.VideoWriter``'s muxer makes the maximum too); the first
  Stream Properties object of the video type gives the stream number and,
  in its type-specific data, a BITMAPINFOHEADER whose compression fourcc
  and the bytes past its 40 (``biSize``) are the codec and its
  extradata, as in AVI (``io/video`` looks the fourcc up with
  ``fourcc_codec``).  Other objects are skipped.
- Data Object packets, one after another from its 50-byte header, as
  ``asf_get_packet`` reads them: error correction data (its length in
  the low nibble of a first byte with the top bit set), the length type
  flags and property flags, the packet length, sequence and padding
  length by their 2-bit types, the send time and duration, and for
  several payloads a payload count with the payload length's type.  Each
  payload: the stream number (and key frame bit), media object number,
  offset into the object and replicated data by their types (eight bytes
  or more: the object's size first), and its length.  A packet shorter
  than the packet size is padded to it.
- Media objects are put together from their fragments by offset, as
  ``ff_asf_parse_packet`` does: a fragment of an object of another size
  than the one in progress, or that runs past its end, drops it and
  starts the next; an object is complete when its bytes are all in.  A
  fragment cut short by the end of the file completes its object with
  the bytes it has; an object left incomplete at the end is dropped.
  An MPEG-2 object of only zero bytes (over 100) is dropped, as FFmpeg
  drops it.  Compressed payloads (replicated data of length 1) raise
  :class:`UnsupportedAsf`.

A file whose headers are cut or hold no video stream raises
:class:`AsfError` (cv2 does not open it).
"""

from __future__ import annotations

import struct
import uuid
from typing import Iterator, Optional, Tuple

_HEADER = uuid.UUID("75b22630-668e-11cf-a6d9-00aa0062ce6c").bytes_le
_DATA = uuid.UUID("75b22636-668e-11cf-a6d9-00aa0062ce6c").bytes_le
_FILE_PROPERTIES = uuid.UUID("8cabdca1-a947-11cf-8ee4-00c00c205365").bytes_le
_STREAM_PROPERTIES = uuid.UUID(
    "b7dc0791-a9b7-11cf-8ee6-00c00c205365").bytes_le
_VIDEO_MEDIA = uuid.UUID("bc19efc0-5b4d-11cf-a8fd-00805f5c442b").bytes_le


class AsfError(ValueError):
    """An ASF file cv2 does not open: the message says why."""


class UnsupportedAsf(ValueError):
    """An ASF file cv2 reads and the port does not: the message names
    what."""


def is_asf(head: bytes) -> bool:
    return head[:16] == _HEADER


def _field(data: bytes, at: int, kind: int, default: int) -> Tuple[int, int]:
    """(value, bytes) of a field of 2-bit length type ``kind`` (0 none, 1
    byte, 2 word, 3 dword; little-endian)."""
    n = (0, 1, 2, 4)[kind & 3]
    if not n:
        return default, 0
    if at + n > len(data):
        raise IndexError
    return int.from_bytes(data[at:at + n], "little"), n


class AsfFile:
    """The first video stream of the ASF file at ``path``: :attr:`fourcc`,
    :attr:`width`, :attr:`height`, :attr:`extradata` and :meth:`frames`."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self._data = data = f.read()
        if len(data) < 30:
            raise AsfError(f"{path}: the ASF header is cut")
        end = struct.unpack_from("<Q", data, 16)[0]
        self.stream = -1
        self.packet_size = 0
        at = 30
        while at + 24 <= min(end, len(data)):
            guid, size = data[at:at + 16], struct.unpack_from("<Q", data,
                                                              at + 16)[0]
            if size < 24 or at + size > len(data):
                raise AsfError(f"{path}: an ASF header object is cut")
            body = data[at + 24:at + size]
            if guid == _FILE_PROPERTIES and len(body) >= 80:
                self.packet_size = struct.unpack_from("<I", body, 68)[0]
            elif guid == _STREAM_PROPERTIES and self.stream < 0 and \
                    body[:16] == _VIDEO_MEDIA:
                self._stream_properties(body)
            at += size
        if self.stream < 0:
            raise AsfError(f"{path}: an ASF file with no video stream")
        if not self.packet_size:
            raise AsfError(f"{path}: ASF File Properties of no packet size")
        if data[end:end + 16] != _DATA:
            raise AsfError(f"{path}: no ASF Data Object after the header")
        self._data_start = end + 50
        size = struct.unpack_from("<Q", data, end + 16)[0] \
            if end + 24 <= len(data) else 0
        self._data_end = end + size if size >= 50 else len(data)

    def _stream_properties(self, body: bytes) -> None:
        n_type = struct.unpack_from("<I", body, 40)[0]
        flags = struct.unpack_from("<H", body, 48)[0]
        spec = body[54:54 + n_type]
        if len(spec) < 11 + 40:
            raise AsfError(f"{self.path}: an ASF video stream without a "
                           f"BITMAPINFOHEADER")
        bih = spec[11:]
        bi_size, width, height = struct.unpack_from("<Iii", bih)
        self.stream = flags & 0x7F
        self.width, self.height = width, abs(height)
        self.fourcc = bih[16:20]
        self.extradata = bih[40:bi_size] if bi_size > 40 else b""

    def _payloads(self) -> Iterator[Tuple[int, int, int, bytes, bool]]:
        """(stream, offset, object size, bytes, cut short) of each
        payload, packet after packet."""
        data, at = self._data, self._data_start
        while at < min(self._data_end, len(data)):
            start = at
            try:
                c = data[at]
                at += 1
                if c & 0x80:                      # error correction data
                    if not c & 0x60:
                        at += c & 0x0F
                    c = data[at]
                    at += 1
                flags, prop = c, data[at]
                at += 1
                length, n = _field(data, at, flags >> 5, self.packet_size)
                at += n
                _, n = _field(data, at, flags >> 1, 0)
                at += n
                pad, n = _field(data, at, flags >> 3, 0)
                at += n
                at += 6                           # send time, duration
                count, size_type = 1, 0x80
                if flags & 1:
                    size_type = data[at]
                    count = size_type & 0x3F
                    at += 1
            except IndexError:
                return
            if not length or pad >= length:
                return
            end = start + length - pad
            try:
                for _ in range(count):
                    if at + 1 > end:
                        break
                    num = data[at]
                    at += 1
                    _, n = _field(data, at, prop >> 4, 0)
                    at += n
                    offset, n = _field(data, at, prop >> 2, 0)
                    at += n
                    replic, n = _field(data, at, prop, 0)
                    at += n
                    if replic == 1:
                        raise UnsupportedAsf(f"{self.path}: ASF compressed "
                                             f"payloads")
                    obj_size = _field(data, at, 3, 0)[0] if replic >= 8 \
                        else 0
                    at += replic
                    frag = end - at
                    if flags & 1:
                        frag, n = _field(data, at, size_type >> 6, 0)
                        at += n
                    part = data[at:at + frag]
                    yield num & 0x7F, offset, obj_size, part, len(part) < frag
                    at += frag
            except IndexError:                    # the file's end
                return
            at = start + max(length, self.packet_size)

    def frames(self) -> Iterator[bytes]:
        """The video stream's media objects, in order."""
        obj: Optional[bytearray] = None
        got = 0
        for stream, offset, size, part, cut in self._payloads():
            if stream != self.stream:
                continue
            if obj is None or len(obj) != size or got + len(part) > size:
                obj, got = bytearray(size), 0
            if offset >= len(obj) or len(part) > len(obj) - offset:
                continue                          # FFmpeg skips it
            obj[offset:offset + len(part)] = part
            if cut:                               # the file's end
                del obj[offset + len(part):]
            got += len(part)
            if got == len(obj):
                done, obj, got = bytes(obj), None, 0
                if not self._zero_mpeg2(done):
                    yield done
            if cut:
                return

    def _zero_mpeg2(self, obj: bytes) -> bool:
        from fealess_tpu_torch.io.mpeg2 import FOURCCS
        return self.fourcc in FOURCCS and len(obj) > 100 and not any(obj)

    def close(self) -> None:
        """Nothing to release: the file was read whole at open."""
