"""An Ogg demuxer (``.ogv``, ``.ogg``): the packets of its first video
stream as FFmpeg's ``ogg`` demuxer hands them to the decoder under
``cv2.VideoCapture``, for VP8 (what ``cv2.VideoWriter`` writes in Ogg).

- Pages: the ``OggS`` capture pattern, version, header type (continued,
  BOS, EOS), granule position, serial, sequence number, CRC and the
  lacing values.  Each page is held to its CRC (polynomial 0x04C11DB7,
  :mod:`~fealess_tpu_torch.io.crc`, over the page with the CRC field
  zeroed).  A page whose CRC fails, or of a version other than 0, is
  skipped: FFmpeg seeks back past its capture pattern and reads on from
  the next ``OggS``; its packets are lost.  A page cut short by the end
  of the file ends the stream.
- Packets, per logical stream, as ``ogg_read_page`` and ``ogg_packet``
  put them together: lacing values of 255 continue a packet, into the
  next page; a page that continues a packet nothing is pending for
  drops that packet's first part, and a packet pending when a page
  arrives takes that page's data whether or not it is flagged as
  continued (so a skipped page leaves the packet without its bytes).
- Streams, by their first packet (``ogg_find_codec``): ``OVP80`` is VP8;
  Theora, Dirac and OGM video are named and refused
  (:class:`UnsupportedOgg`); audio, Skeleton and unknown streams are
  passed over.  VP8's header packets (``OVP80``, type 0x01 the stream
  info, version 1, type 0x02 the comments) come first, read at open as
  FFmpeg reads them; the first packet that is not one is the first
  frame.  A file without a video stream, or whose VP8 stream header
  FFmpeg refuses, raises :class:`OggError` (cv2 does not open it).  Empty packets are passed over.
"""

from __future__ import annotations

import struct
from typing import Iterator, List, Tuple

from fealess_tpu_torch.io.crc import crc32

_CONT = 0x01
# the first bytes of the first packet of a video stream FFmpeg decodes
# and the port does not
_NAMED_VIDEO = ((b"\x80theora", "Theora"), (b"BBCD\x00", "Dirac"),
                (b"KW-DIRAC", "Dirac"), (b"\x01video", "OGM video"))


class OggError(ValueError):
    """An Ogg file cv2 does not open: the message says why."""


class UnsupportedOgg(ValueError):
    """An Ogg file cv2 reads and the port does not: the message names
    what."""


def is_ogg(head: bytes) -> bool:
    return head[:4] == b"OggS"


def pages(data: bytes) -> Iterator[Tuple[int, int, bytes, bytes]]:
    """(serial, header type, lacing values, body) of each page whose CRC
    holds, in file order (see the module docstring)."""
    at = data.find(b"OggS")
    while 0 <= at and at + 27 <= len(data):
        version, flags, _, serial, _, crc, nsegs = struct.unpack_from(
            "<BBqIIIB", data, at + 4)
        lacing = data[at + 27:at + 27 + nsegs]
        end = at + 27 + nsegs + sum(lacing)
        if len(lacing) < nsegs or end > len(data):
            return                                 # cut short: the end
        page = bytearray(data[at:end])
        page[22:26] = bytes(4)
        if crc32(page) != crc or version:
            at = data.find(b"OggS", at + 4)       # FFmpeg's resync
            continue
        yield serial, flags, bytes(lacing), data[at + 27 + nsegs:end]
        at = data.find(b"OggS", end)


class _Stream:
    """One logical stream's packet assembly (``ogg_read_page`` and
    ``ogg_packet``)."""

    def __init__(self):
        self.buf = bytearray()
        self.pstart = self.psize = 0
        self.lacing, self.segp = b"", 0
        self.incomplete = False

    def add_page(self, flags: int, lacing: bytes, body: bytes) -> List[bytes]:
        """The packets the page completes."""
        if self.pstart == len(self.buf):
            self.buf, self.pstart = bytearray(), 0
        self.buf += body
        self.lacing, self.segp = lacing, 0
        if flags & _CONT or self.incomplete:
            if not self.psize:       # started inside a packet: drop it
                while self.segp < len(lacing):
                    seg = lacing[self.segp]
                    self.segp += 1
                    self.pstart += seg
                    if seg < 255:
                        break
        else:
            self.psize = 0
        out = []
        while True:
            complete = False
            while self.segp < len(self.lacing):
                seg = self.lacing[self.segp]
                self.segp += 1
                self.psize += seg
                if seg < 255:
                    complete = True
                    break
            if not complete:
                self.incomplete = bool(self.psize)
                return out
            self.incomplete = False
            out.append(bytes(self.buf[self.pstart:self.pstart + self.psize]))
            self.pstart += self.psize
            self.psize = 0


class OggFile:
    """The first video stream of the Ogg file at ``path``: :attr:`codec`
    (``"vp8"``), :attr:`width`, :attr:`height` and :meth:`frames`."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self._data = f.read()
        self.serial = self._video_serial()
        self.codec = "vp8"
        self.width = self.height = 0
        for _ in self.frames():     # FFmpeg reads the headers at open
            break

    def _video_serial(self) -> int:
        streams = {}
        for serial, flags, lacing, body in pages(self._data):
            if serial in streams:
                continue
            first = streams[serial] = _Stream()
            packets = first.add_page(flags, lacing, body)
            if not packets:
                continue
            head = packets[0]
            if head.startswith(b"OVP80"):
                return serial
            for magic, name in _NAMED_VIDEO:
                if head.startswith(magic):
                    raise UnsupportedOgg(f"{self.path}: Ogg with {name} "
                                         f"video")
        raise OggError(f"{self.path}: an Ogg file with no video stream")

    def _packets(self) -> Iterator[bytes]:
        stream = _Stream()
        for serial, flags, lacing, body in pages(self._data):
            if serial == self.serial:
                yield from stream.add_page(flags, lacing, body)

    def frames(self) -> Iterator[bytes]:
        """The VP8 frames: the packets after the stream's header
        packets."""
        headers, info = True, False
        for packet in self._packets():
            if headers and len(packet) >= 7 and packet[0] == 0x4F:
                self._header(packet)
                info = info or packet[5] == 0x01
                continue
            if headers and not info:
                raise OggError(f"{self.path}: the VP8 stream has no stream "
                               f"info header")
            headers = False
            if packet:
                yield packet

    def _header(self, p: bytes) -> None:
        """Check a VP8 header packet as ``vp8_header`` does."""
        if p[5] == 0x01:
            if len(p) < 26 or p[6] != 1:
                raise OggError(f"{self.path}: an Ogg VP8 stream info header "
                               f"FFmpeg refuses")
            self.width, self.height = struct.unpack_from(">HH", p, 8)
        elif p[5] != 0x02 or p[6] != 0x20:
            raise OggError(f"{self.path}: an Ogg VP8 header of type "
                           f"{p[5]:#04x} FFmpeg refuses")

    def close(self) -> None:
        """Nothing to release: the file was read whole at open."""
