"""A Matroska / WebM demuxer: the frames of a file's first video track,
as FFmpeg's ``matroska`` demuxer hands them to the decoder under
``cv2.VideoCapture``.

- EBML: an element's ID (1-4 bytes, marker kept) and size (1-8 bytes,
  marker dropped; all ones is an unknown size, which ends where an
  element that is not its child starts, or at the end of its parent).
- The EBML header, then ``Segment``; in it ``Tracks`` / ``TrackEntry``
  (``TrackNumber``, ``TrackType`` 1 for video, ``CodecID``,
  ``CodecPrivate``, ``Video`` with ``PixelWidth``, ``PixelHeight`` and
  ``ColourSpace``, ``ContentEncodings``) and each ``Cluster``'s
  ``SimpleBlock`` and ``BlockGroup`` / ``Block``, laced or not (Xiph,
  fixed-size and EBML lacing).  Other elements (``SeekHead``, ``Info``,
  ``Cues``, ``Tags``, ``Void``, ``CRC-32``, ...) are stepped over.
- The codec is the ``CodecID``'s (``ff_mkv_codec_tags``): ``V_FFV1`` and
  ``V_MPEG2`` (``CodecPrivate`` is the extradata), ``V_MJPEG``,
  ``V_UNCOMPRESSED``
  (the raw format is ``ColourSpace``'s fourcc) and ``V_MS/VFW/FOURCC``
  (``CodecPrivate`` is a BITMAPINFOHEADER: the fourcc at byte 16, the
  extradata past byte 40).

A track whose blocks are compressed (``ContentEncodings``) raises
:class:`UnsupportedMatroska`; a file whose structure is cut or has no
video track raises :class:`MatroskaError`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import BinaryIO, Iterator, List, Optional, Tuple

EBML_MAGIC = b"\x1a\x45\xdf\xa3"

_SEGMENT, _TRACKS, _TRACK_ENTRY, _CLUSTER = (0x18538067, 0x1654AE6B, 0xAE,
                                             0x1F43B675)
_SIMPLE_BLOCK, _BLOCK_GROUP, _BLOCK = 0xA3, 0xA0, 0xA1
_TRACK_NUMBER, _TRACK_TYPE, _CODEC_ID, _CODEC_PRIVATE = (0xD7, 0x83, 0x86,
                                                         0x63A2)
_VIDEO, _PIXEL_WIDTH, _PIXEL_HEIGHT, _COLOUR_SPACE = (0xE0, 0xB0, 0xBA,
                                                      0x2EB524)
_CONTENT_ENCODINGS = 0x6D80
# the elements at the Segment's level: an unknown-size Cluster ends where
# one of them starts
_LEVEL1 = (0x114D9B74, 0x1549A966, _TRACKS, _CLUSTER, 0x1C53BB6B,
           0x1254C367, 0x1043A770, 0x1941A469, _SEGMENT, 0x1A45DFA3)

# ff_mkv_codec_tags: the CodecIDs named when refused
CODEC_NAMES = {"V_VP8": "VP8", "V_VP9": "VP9", "V_AV1": "AV1",
               "V_MPEG4/ISO/AVC": "H.264", "V_MPEGH/ISO/HEVC": "HEVC",
               "V_MPEG1": "MPEG-1",
               "V_THEORA": "Theora",
               "V_PRORES": "ProRes", "V_DIRAC": "Dirac",
               "V_QUICKTIME": "QuickTime", "V_SNOW": "Snow"}


class MatroskaError(ValueError):
    """A Matroska file the demuxer cannot read: the message says why."""


class UnsupportedMatroska(ValueError):
    """A Matroska file cv2 reads and the port does not: the message names
    what."""


def is_ebml(head: bytes) -> bool:
    return head[:4] == EBML_MAGIC


@dataclass
class MkvTrack:
    number: int
    codec_id: str
    codec_private: bytes
    width: int
    height: int
    colour_space: bytes


def _vint(data: bytes, at: int, keep_marker: bool) -> Tuple[int, int, bool]:
    """(value, length, all value bits set) of the variable-size integer
    at ``at``."""
    if at >= len(data):
        raise MatroskaError("element header past the end")
    first = data[at]
    n = 1
    while n <= 8 and not first & (0x80 >> (n - 1)):
        n += 1
    if n > 8 or at + n > len(data):
        raise MatroskaError(f"bad EBML number at {at}")
    value = first if keep_marker else first & (0xFF >> n)
    for b in data[at + 1:at + n]:
        value = (value << 8) | b
    ones = not keep_marker and value == (1 << (7 * n)) - 1
    return value, n, ones


def _uint(body: bytes) -> int:
    return int.from_bytes(body, "big") if body else 0


class MkvFile:
    """The first video track of the Matroska file at ``path``:
    :attr:`track` and :meth:`frames`.  Close it (or use it as a context
    manager)."""

    def __init__(self, path: str):
        self.path = path
        self._f: BinaryIO = open(path, "rb")
        try:
            self._size = self._f.seek(0, 2)
            self.track: Optional[MkvTrack] = None
            self._clusters: List[Tuple[int, int]] = []
            self._scan()
            if self.track is None:
                raise MatroskaError(f"{path}: the file has no video track")
        except IndexError as e:
            self._f.close()
            raise MatroskaError(f"{path}: cut ({e})") from None
        except BaseException:
            self._f.close()
            raise

    def _read(self, at: int, n: int) -> bytes:
        self._f.seek(at)
        return self._f.read(n)

    def _header(self, at: int) -> Tuple[int, int, int]:
        """(ID, body offset, body size or -1 when unknown) of the element
        at ``at`` in the file."""
        head = self._read(at, 12)
        try:
            eid, n, _ = _vint(head, 0, True)
            size, m, unknown = _vint(head, n, False)
        except MatroskaError as e:
            raise MatroskaError(f"{self.path}: {e}") from None
        return eid, at + n + m, -1 if unknown else size

    def _elements(self, start: int, end: int) -> Iterator[
            Tuple[int, int, int]]:
        """(ID, body offset, body end) of each element in [start, end), up
        to an element of unknown size (body end -1)."""
        at = start
        while at + 2 <= end:
            eid, body, size = self._header(at)
            if size < 0:
                yield eid, body, -1
                return
            yield eid, body, min(body + size, end)
            at = body + size

    def _scan(self) -> None:
        at = 0
        while at < self._size:
            eid, body, size = self._header(at)
            if eid == _SEGMENT:
                self._segment(body, self._size if size < 0 else
                              min(body + size, self._size))
                return
            if size < 0:
                break
            at = body + size
        raise MatroskaError(f"{self.path}: no Segment")

    def _segment(self, start: int, end: int) -> None:
        at = start
        while at + 2 <= end:
            eid, body, size = self._header(at)
            stop = body + size if size >= 0 else None
            if eid == _TRACKS and self.track is None:
                self._tracks(self._read(body, size if size >= 0 else
                                        end - body))
            elif eid == _CLUSTER:
                if stop is None:       # unknown size: up to the next level-1
                    stop = self._unknown_end(body, end)
                self._clusters.append((body, min(stop, end)))
            elif stop is None:
                break
            at = stop

    def _unknown_end(self, start: int, end: int) -> int:
        """Where an unknown-size Cluster starting at ``start`` ends."""
        at = start
        while at + 2 <= end:
            eid, body, size = self._header(at)
            if eid in _LEVEL1 or size < 0:
                return at
            at = body + size
        return end

    @staticmethod
    def _children(data: bytes, start: int = 0, end: Optional[int] = None):
        end = len(data) if end is None else end
        at = start
        while at < end:
            eid, n, _ = _vint(data, at, True)
            size, m, unknown = _vint(data, at + n, False)
            body = at + n + m
            stop = end if unknown else min(body + size, end)
            yield eid, data[body:stop]
            at = stop

    def _tracks(self, data: bytes) -> None:
        for eid, entry in self._children(data):
            if eid != _TRACK_ENTRY:
                continue
            f = {}
            video = {}
            for kid, body in self._children(entry):
                if kid == _VIDEO:
                    video = dict(self._children(body))
                else:
                    f.setdefault(kid, body)
            if _uint(f.get(_TRACK_TYPE, b"")) != 1:
                continue
            codec = f.get(_CODEC_ID, b"").rstrip(b"\0").decode("latin-1")
            if _CONTENT_ENCODINGS in f:
                raise UnsupportedMatroska(
                    f"{self.path}: Matroska track with compressed or "
                    f"encrypted blocks (ContentEncodings, {codec})")
            self.track = MkvTrack(
                number=_uint(f.get(_TRACK_NUMBER, b"")), codec_id=codec,
                codec_private=f.get(_CODEC_PRIVATE, b""),
                width=_uint(video.get(_PIXEL_WIDTH, b"")),
                height=_uint(video.get(_PIXEL_HEIGHT, b"")),
                colour_space=video.get(_COLOUR_SPACE, b""))
            return

    # ---- blocks ----

    def _laced(self, data: bytes, at: int, lacing: int) -> List[bytes]:
        """The frames of a block's payload from ``at``."""
        if lacing == 0:
            return [data[at:]]
        count = data[at] + 1
        at += 1
        sizes: List[int] = []
        if lacing == 1:                        # Xiph
            for _ in range(count - 1):
                n = 0
                while True:
                    b = data[at]
                    at += 1
                    n += b
                    if b != 255:
                        break
                sizes.append(n)
        elif lacing == 3:                      # EBML
            first, n, _ = _vint(data, at, False)
            at += n
            sizes.append(first)
            for _ in range(count - 2):
                raw, n, _ = _vint(data, at, False)
                at += n
                sizes.append(sizes[-1] + raw - ((1 << (7 * n - 1)) - 1))
        else:                                  # fixed-size
            each = (len(data) - at) // count
            return [data[at + each * i:at + each * (i + 1)]
                    for i in range(count)]
        rest = len(data) - at - sum(sizes)
        if rest < 0 or any(s < 0 for s in sizes):
            raise MatroskaError(f"{self.path}: bad lacing")
        out = []
        for s in sizes + [rest]:
            out.append(data[at:at + s])
            at += s
        return out

    def _block(self, data: bytes) -> List[bytes]:
        """The track's frames in a (Simple)Block's body."""
        number, n, _ = _vint(data, 0, False)
        if number != self.track.number:
            return []
        flags = data[n + 2]
        return self._laced(data, n + 3, (flags >> 1) & 3)

    def frames(self) -> Iterator[bytes]:
        """Each frame of the track in file order (an empty one yields
        nothing)."""
        for start, end in self._clusters:
            for eid, body, stop in self._elements(start, end):
                if stop < 0:
                    break
                if eid == _SIMPLE_BLOCK:
                    blocks = [self._read(body, stop - body)]
                elif eid == _BLOCK_GROUP:
                    group = self._read(body, stop - body)
                    blocks = [b for kid, b in self._children(group)
                              if kid == _BLOCK]
                else:
                    continue
                for block in blocks:
                    try:
                        frames = self._block(block)
                    except (IndexError, MatroskaError):
                        raise MatroskaError(f"{self.path}: a block is cut "
                                            f"or badly laced") from None
                    for frame in frames:
                        if frame:
                            yield frame

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "MkvFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
