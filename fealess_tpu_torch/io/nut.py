"""A NUT demuxer (``.nut``): the frames of its first video stream as
FFmpeg's ``nut`` demuxer hands them to the decoder under
``cv2.VideoCapture``.

NUT (FFmpeg's own container, its specification in FFmpeg's
``doc/nut.texi``) is a run of packets, each a 64-bit start code, a
forward pointer (a ``v``: 7 bits a byte, high bit set on all bytes but
the last), a header checksum where the pointer is over 4096, the body and
a checksum of the body (:mod:`~fealess_tpu_torch.io.crc`, from 0; with
the checksum after it the CRC is 0); frames sit between packets.

- The main header (version 2 to 4, the stream count, ``max_distance``,
  the time bases, the 256-entry frame code table by the specification's
  loop of flags, fields, pts delta, size multiplier and lsb, stream,
  reserved count, count and header index, the elision headers, the flags
  of version 4), then each stream header (its id, class, fourcc, time
  base, msb pts shift, ``max_pts_distance``, decode delay, flags, the
  codec-specific data (extradata), width, height, aspect and colour
  space), each held to its checksum as ``nut_read_header`` does: a header
  whose checksum fails is passed over for the next one of its kind, and
  where none is left the file does not open (:class:`NutError`, as cv2
  does not open it).
- Syncpoints (their checksum; a syncpoint that fails is resynced past,
  to the next start code, and the frames up to it are lost, as FFmpeg
  loses them), info packets, the index and repeated headers (skipped),
  and frames by their frame code: coded flags, stream id, coded pts, the
  size's msb, match time, header index, reserved fields and a checksum
  (read, not held: FFmpeg does not check it), each frame's pts tracked to
  apply FFmpeg's distance checks (a frame past ``max_distance`` after its
  syncpoint, or too far in size or pts without a checksum, resyncs).  An
  elided header (``header_idx`` above 0) is put back before the frame's
  bytes; a main header without the elision table leaves FFmpeg no
  header 0, so no frame reads.  A frame cut short by the end of the file
  gives the bytes it has.  Side data (``FLAG_SM_DATA``) raises :class:`UnsupportedNut`.

The stream's fourcc picks the codec as FFmpeg's tag tables do (``io/video``
looks it up with ``fourcc_codec``, as for AVI; FFmpeg's NUT raw-video tags
name raw formats).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

from fealess_tpu_torch.io.crc import crc32


def _code(tag: bytes, low: int) -> int:
    return (int.from_bytes(tag, "big") << 48) | low


MAIN = _code(b"NM", 0x7A561F5F04AD)
STREAM = _code(b"NS", 0x11405BF2F9DB)
SYNCPOINT = _code(b"NK", 0xE4ADEECA4569)
INDEX = _code(b"NX", 0xDD672F23E64E)
INFO = _code(b"NI", 0xAB68B596BA78)
_CODES = (MAIN, STREAM, SYNCPOINT, INDEX, INFO)
FILE_ID = b"nut/multimedia container\x00"

F_KEY, F_CODED_PTS, F_STREAM_ID, F_SIZE_MSB = 1, 8, 16, 32
F_CHECKSUM, F_RESERVED, F_SM_DATA, F_HEADER_IDX = 64, 128, 256, 1024
F_MATCH_TIME, F_CODED, F_INVALID = 2048, 4096, 8192
_PIPE = 2


class NutError(ValueError):
    """A NUT file cv2 does not open: the message says why."""


class UnsupportedNut(ValueError):
    """A NUT file cv2 reads and the port does not: the message names
    what."""


def is_nut(head: bytes) -> bool:
    return head.startswith(b"nut/multimedia container")


class _Reader:
    """Variable-length fields from a bytes object."""

    def __init__(self, data: bytes, at: int):
        self.data, self.at = data, at

    def u8(self) -> int:
        if self.at >= len(self.data):
            raise EOFError
        self.at += 1
        return self.data[self.at - 1]

    def v(self) -> int:
        val = 0
        while True:
            b = self.u8()
            val = (val << 7) | (b & 0x7F)
            if not b & 0x80:
                return val

    def s(self) -> int:
        v = self.v() + 1
        return -(v >> 1) if v & 1 else v >> 1

    def raw(self, n: int) -> bytes:
        if self.at + n > len(self.data):
            raise EOFError
        self.at += n
        return self.data[self.at - n:self.at]


@dataclass
class _FrameCode:
    flags: int = F_INVALID
    pts_delta: int = 0
    stream: int = 0
    size_mul: int = 1
    size_lsb: int = 0
    reserved: int = 0
    header_idx: int = 0


@dataclass
class NutStream:
    kind: int                   # 0 video, 1 audio, 2 subtitles, 3 user data
    fourcc: bytes
    time_base: Tuple[int, int]
    msb_pts_shift: int
    max_pts_distance: int
    extradata: bytes
    width: int = 0
    height: int = 0


class NutFile:
    """The first video stream of the NUT file at ``path``:
    :attr:`stream` (a :class:`NutStream`; its :attr:`fourcc`,
    :attr:`width`, :attr:`height` and :attr:`extradata`) and
    :meth:`frames`."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self._data = f.read()
        self.streams: List[Optional[NutStream]] = []
        at = -1
        while True:                              # the main header
            at = self._find(MAIN, at + 1)
            if at < 0:
                raise NutError(f"{path}: no valid NUT main header")
            if self._main_header(at):
                break
        at = -1
        while not all(self.streams):             # the stream headers
            at = self._find(STREAM, at + 1)
            if at < 0:
                raise NutError(f"{path}: not all NUT stream headers found")
            self._stream_header(at)
        video = [i for i, s in enumerate(self.streams) if s.kind == 0]
        if not video:
            raise NutError(f"{path}: a NUT file with no video stream")
        self.index = video[0]
        self.stream = s = self.streams[self.index]
        self.fourcc, self.extradata = s.fourcc, s.extradata
        self.width, self.height = s.width, s.height
        self._data_start = self._find(SYNCPOINT, 0)
        if self._data_start < 0:
            raise NutError(f"{path}: no NUT syncpoint (EOF before video "
                           f"frames)")

    # ---- packets ----

    def _find(self, code: int, at: int) -> int:
        """Where the first start code ``code`` (or any, for 0) at or
        after ``at`` begins, or -1."""
        data = self._data
        k = at
        while True:
            k = data.find(b"N", k)
            if k < 0 or k + 8 > len(data):
                return -1
            c = int.from_bytes(data[k:k + 8], "big")
            if c == code or (code == 0 and c in _CODES):
                return k
            k += 1

    def _packet(self, at: int, check: bool = True) -> Optional[_Reader]:
        """A reader over the body of the packet whose start code is at
        ``at`` (its checksum held where ``check``), or None where a
        checksum fails or the packet is cut."""
        data = self._data
        r = _Reader(data, at + 8)
        try:
            size = r.v()
            if size > 4096:
                r.raw(4)
                if crc32(data[at:r.at]) != 0:
                    return None
            body = r.at
            end = body + size
            if end > len(data) or size < 4:
                return None
            if check and crc32(data[body:end]) != 0:
                return None
        except EOFError:
            return None
        r.end = end - 4
        return r

    def _main_header(self, at: int) -> bool:
        r = self._packet(at)
        if r is None:
            return False
        try:
            self.version = r.v()
            if not 2 <= self.version <= 4:
                return False
            if self.version > 3:
                r.v()                                   # minor version
            count = r.v()
            self.max_distance = min(r.v(), 65536)
            self.time_bases = [(r.v(), r.v()) for _ in range(r.v())]
            codes = [_FrameCode() for _ in range(256)]
            pts, mul, stream, head_idx, i = 0, 1, 0, 0, 0
            while i < 256:
                flags, fields = r.v(), r.v()
                if fields > 0:
                    pts = r.s()
                if fields > 1:
                    mul = r.v()
                if fields > 2:
                    stream = r.v()
                size = r.v() if fields > 3 else 0
                reserved = r.v() if fields > 4 else 0
                count_ = r.v() if fields > 5 else mul - size
                if fields > 6:
                    r.s()
                if fields > 7:
                    head_idx = r.v()
                for _ in range(fields - 8):
                    r.v()
                if count_ <= 0 or count_ > 256 - (i <= 0x4E) - i:
                    return False
                j = 0
                while j < count_:
                    if i == 0x4E:                      # 'N'
                        i += 1
                        continue
                    codes[i] = _FrameCode(flags, pts, stream, mul, size + j,
                                          reserved, head_idx)
                    i += 1
                    j += 1
            # without the elision table FFmpeg has no header 0 either, and
            # every frame's header index is out of range
            self.headers = []
            if r.end > r.at:
                self.headers = [b""] + [r.raw(r.v()) for _ in range(r.v())]
            self.flags = r.v() if self.version > 3 and r.end > r.at else 0
        except EOFError:
            return False
        self.codes = codes
        self.streams = [None] * count
        return True

    def _stream_header(self, at: int) -> None:
        r = self._packet(at)
        if r is None:
            return
        try:
            sid = r.v()
            if sid >= len(self.streams) or self.streams[sid] is not None:
                return
            kind = r.v()
            fourcc = r.raw(r.v())
            tb = r.v()
            if tb >= len(self.time_bases):
                return
            shift, max_pts, _ = r.v(), r.v(), r.v()
            r.v()                                       # stream flags
            extradata = r.raw(r.v())
            stream = NutStream(kind, fourcc, self.time_bases[tb], shift,
                               max_pts, extradata)
            if kind == 0:
                stream.width, stream.height = r.v(), r.v()
        except EOFError:
            return
        self.streams[sid] = stream

    # ---- frames ----

    def _reset_ts(self, tb: Tuple[int, int], val: int,
                  last: Dict[int, int]) -> None:
        for i, s in enumerate(self.streams):
            num = tb[0] * s.time_base[1]
            den = tb[1] * s.time_base[0]
            last[i] = val * num // den

    def frames(self) -> Iterator[bytes]:
        data = self._data
        last_pts = {i: 0 for i in range(len(self.streams))}
        at, syncpoint, resynced = self._data_start, -1, -1
        while at < len(data):
            code = data[at]
            if code == 0x4E and at + 8 <= len(data):
                sc = int.from_bytes(data[at:at + 8], "big")
                if sc == SYNCPOINT:
                    syncpoint = at
                    r = self._packet(at)
                    if r is not None:
                        try:
                            t = r.v()
                            r.v()                            # back_ptr
                            n = len(self.time_bases)
                            self._reset_ts(self.time_bases[t % n], t // n,
                                           last_pts)
                            at = r.end + 4
                            continue
                        except EOFError:
                            pass
                elif sc in (MAIN, STREAM, INDEX, INFO):
                    r = self._packet(at, check=sc == INFO)
                    if r is not None:
                        at = r.end + 4
                        continue
                got = None        # a damaged packet or an unknown code
            else:
                got = self._frame(at, syncpoint, last_pts)
            if got is None:                    # resync at a start code
                at = self._find(0, max(syncpoint, resynced) + 1)
                if at < 0:
                    return
                resynced = at + 8
                continue
            at, sid, frame = got
            if sid == self.index:
                yield frame

    def _frame(self, at: int, syncpoint: int, last_pts: Dict[int, int]):
        """(next offset, stream id, bytes) of the frame at ``at``, or None
        where FFmpeg's frame header checks fail."""
        data = self._data
        if not self.flags & _PIPE and at + 1 > syncpoint + self.max_distance:
            return None
        fc = self.codes[data[at]]
        flags, size, sid = fc.flags, fc.size_lsb, fc.stream
        head_idx, reserved = fc.header_idx, fc.reserved
        if flags & F_INVALID:
            return None
        r = _Reader(data, at + 1)
        try:
            if flags & F_CODED:
                flags ^= r.v()
            if flags & F_STREAM_ID:
                sid = r.v()
                if sid >= len(self.streams):
                    return None
            s = self.streams[sid]
            if flags & F_CODED_PTS:
                coded = r.v()
                if coded < 1 << s.msb_pts_shift:
                    mask = (1 << s.msb_pts_shift) - 1
                    delta = last_pts[sid] - mask // 2
                    pts = ((coded - delta) & mask) + delta
                else:
                    pts = coded - (1 << s.msb_pts_shift)
            else:
                pts = last_pts[sid] + fc.pts_delta
            if flags & F_SIZE_MSB:
                size += fc.size_mul * r.v()
            if flags & F_MATCH_TIME:
                r.s()
            if flags & F_HEADER_IDX:
                head_idx = r.v()
            if flags & F_RESERVED:
                reserved = r.v()
            for _ in range(reserved):
                r.v()
            if head_idx >= len(self.headers):
                return None
            if size > 4096:
                head_idx = 0
            size -= len(self.headers[head_idx])
            if flags & F_CHECKSUM:
                r.raw(4)
            elif (not self.flags & _PIPE and size > 2 * self.max_distance) \
                    or abs(last_pts[sid] - pts) > s.max_pts_distance:
                return None
        except EOFError:
            return None
        if flags & F_SM_DATA:
            raise UnsupportedNut(f"{self.path}: NUT frames with side data")
        last_pts[sid] = pts
        body = data[r.at:r.at + size]
        return r.at + size, sid, self.headers[head_idx] + body

    def close(self) -> None:
        """Nothing to release: the file was read whole at open."""
