"""A RIFF AVI demuxer: the frames of an AVI's first video stream, as
FFmpeg's ``avi`` demuxer hands them to the decoder under
``cv2.VideoCapture``.

- Headers: ``hdrl``'s ``avih`` and each ``strl``'s ``strh``, ``strf``
  (a BITMAPINFOHEADER: size, compression fourcc, extradata after its 40
  bytes) and ``indx``.  The first stream whose ``strh`` type is ``vids`` is
  read; its chunks are ``NNdc`` / ``NNdb`` (``NN`` its number).
- Frames, in index order: OpenDML's ``indx`` (a super index of ``ix##``
  standard indexes, or a standard index itself) where the stream has one,
  else ``idx1`` (offsets relative to ``movi`` or absolute: the first entry
  is mapped onto the first chunk of ``movi``, as ``avi_read_idx1`` maps
  it) followed by the ``RIFF AVIX`` extensions' chunks, else a walk of
  ``movi`` and of each extension's ``movi``.  A walk steps over ``JUNK``,
  ``ix##`` and other streams' chunks and into ``LIST rec``.  A chunk of
  length zero yields no frame (FFmpeg leaves it out of its index and cv2
  returns no frame for it).

A file that is not a RIFF ``AVI `` / ``AVIX`` raises
:class:`NotAvi`; an AVI without a video stream, or whose headers or index
are cut, raises :class:`AviError`.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import BinaryIO, Iterator, List, Optional, Tuple


class NotAvi(ValueError):
    """The file is not a RIFF AVI."""


class AviError(ValueError):
    """An AVI the demuxer cannot read: the message says why."""


@dataclass
class VideoStream:
    number: int             # NN of the stream's NNdc chunks
    handler: bytes          # strh fccHandler
    compression: bytes      # strf biCompression (the codec's fourcc)
    width: int
    height: int             # strf biHeight (negative: top-down)
    extradata: bytes        # strf past its 40-byte BITMAPINFOHEADER


def is_avi(head: bytes) -> bool:
    return (len(head) >= 12 and head[:4] == b"RIFF"
            and head[8:12] in (b"AVI ", b"AVIX"))


def _u32(b: bytes, at: int = 0) -> int:
    return struct.unpack_from("<I", b, at)[0]


class AviFile:
    """The first video stream of the AVI at ``path``: :attr:`stream` and
    :meth:`frames`.  Close it (or use it as a context manager)."""

    def __init__(self, path: str):
        self._f: BinaryIO = open(path, "rb")
        try:
            self._size = self._f.seek(0, 2)
            self._f.seek(0)
            head = self._f.read(12)
            if not is_avi(head):
                raise NotAvi(f"{path}: not a RIFF AVI file")
            self.path = path
            self.stream: Optional[VideoStream] = None
            self._indx = b""
            self._movi: List[Tuple[int, int]] = []   # (start, end) of data
            self._idx1: Optional[bytes] = None
            self._read_riff(12, min(self._size, 8 + _u32(head, 4)), True)
            if self.stream is None:
                raise AviError(f"{path}: the AVI has no video stream")
            self._entries = self._index()
        except BaseException:
            self._f.close()
            raise

    # ---- headers ----

    def _read(self, at: int, n: int) -> bytes:
        self._f.seek(at)
        return self._f.read(n)

    def _chunks(self, start: int, end: int) -> Iterator[Tuple[bytes, int,
                                                                int]]:
        """(id, data offset, size) of each chunk in [start, end)."""
        at = start
        while at + 8 <= end:
            head = self._read(at, 8)
            if len(head) < 8:
                return
            cid, size = head[:4], _u32(head, 4)
            yield cid, at + 8, size
            at += 8 + size + (size & 1)

    def _read_riff(self, start: int, end: int, first: bool) -> None:
        for cid, at, size in self._chunks(start, end):
            if cid == b"LIST":
                kind = self._read(at, 4)
                if kind == b"hdrl" and first:
                    self._read_hdrl(at + 4, at + size)
                elif kind == b"movi":
                    self._movi.append((at + 4, min(at + size, self._size)))
            elif cid == b"idx1" and first:
                self._idx1 = self._read(at, size)
        if first:
            # RIFF AVIX extensions follow the first RIFF
            at = end + (end & 1)
            while at + 12 <= self._size:
                head = self._read(at, 12)
                if head[:4] != b"RIFF" or head[8:12] != b"AVIX":
                    break
                size = _u32(head, 4)
                self._read_riff(at + 12, min(at + 8 + size, self._size),
                                False)
                at += 8 + size + (size & 1)

    def _read_hdrl(self, start: int, end: int) -> None:
        number = 0
        for cid, at, size in self._chunks(start, end):
            if cid != b"LIST" or self._read(at, 4) != b"strl":
                continue
            parts = {}
            for sid, sat, ssize in self._chunks(at + 4, at + size):
                parts.setdefault(sid, self._read(sat, ssize))
            strh, strf = parts.get(b"strh", b""), parts.get(b"strf", b"")
            if self.stream is None and strh[:4] == b"vids":
                if len(strh) < 8 or len(strf) < 40:
                    raise AviError(f"{self.path}: the video stream's "
                                   f"header is cut")
                _, width, height, _, _, comp = struct.unpack_from(
                    "<IiiHH4s", strf)
                self.stream = VideoStream(
                    number=number, handler=strh[4:8], compression=comp,
                    width=width, height=height, extradata=strf[40:])
                self._indx = parts.get(b"indx", b"")
            number += 1

    # ---- the frames' chunks ----

    def _is_frame(self, cid: bytes) -> bool:
        return (cid[:2] == b"%02d" % self.stream.number
                and cid[2:] in (b"dc", b"db"))

    def _odml(self, data: bytes, out: list, depth: int = 0) -> None:
        """read_odml_index: a super index recurses into the ix## chunks
        it points at; a standard index adds (chunk position, size)."""
        if len(data) < 24 or depth > 2:
            raise AviError(f"{self.path}: OpenDML index is cut")
        _, sub, kind, n = struct.unpack_from("<HBBI", data)
        base = struct.unpack_from("<Q", data, 12)[0]
        if sub:
            raise AviError(f"{self.path}: OpenDML index of sub-type {sub}")
        at = 24
        last = None
        for _ in range(n):
            if kind:
                if at + 8 > len(data):
                    raise AviError(f"{self.path}: OpenDML index is cut")
                off, size = struct.unpack_from("<II", data, at)
                pos = off + base - 8
                size &= 0x7FFFFFFF
                if pos != last and size:
                    out.append(pos)
                last = pos
                at += 8
            else:
                if at + 16 > len(data):
                    raise AviError(f"{self.path}: OpenDML index is cut")
                off = struct.unpack_from("<Q", data, at)[0]
                head = self._read(off, 8)
                if len(head) < 8:
                    raise AviError(f"{self.path}: OpenDML index points "
                                   f"past the end of the file")
                self._odml(self._read(off + 8, _u32(head, 4)), out,
                           depth + 1)
                at += 16

    def _first_chunk(self) -> Optional[int]:
        """Position of the first chunk of any stream in the first movi."""
        if not self._movi:
            return None
        for cid, at, size in self._chunks(*self._movi[0]):
            if cid == b"LIST":
                for rid, rat, _ in self._chunks(at + 4, at + size):
                    if rid[:2].isdigit():
                        return rat - 8
            elif cid[:2].isdigit():
                return at - 8
        return None

    def _idx1_entries(self) -> List[int]:
        data, out = self._idx1, []
        offset, first, last = 0, True, None
        for i in range(len(data) // 16):
            cid, flags, pos, size = struct.unpack_from("<4sIII", data,
                                                       16 * i)
            if not cid[:2].isdigit() or cid[2:] == b"pc":
                continue
            if first:
                start = self._first_chunk()
                if start is not None:
                    offset = start - pos
                first = False
            pos += offset
            if self._is_frame(cid) and pos != last and size:
                out.append(pos)
            if self._is_frame(cid):
                last = pos
        return out

    def _walk(self, movi) -> List[int]:
        out: List[int] = []

        def walk(start, end):
            for cid, at, size in self._chunks(start, end):
                if cid == b"LIST":
                    if self._read(at, 4) == b"rec ":
                        walk(at + 4, at + size)
                elif self._is_frame(cid) and size:
                    out.append(at - 8)
        for start, end in movi:
            walk(start, end)
        return out

    def _index(self) -> List[int]:
        if self._indx:
            out: List[int] = []
            self._odml(self._indx, out)
            return out
        if self._idx1:
            # idx1 lists the first RIFF's chunks; FFmpeg reads on into the
            # AVIX extensions' movi lists
            return self._idx1_entries() + self._walk(self._movi[1:])
        return self._walk(self._movi)

    # ---- reading ----

    def frames(self) -> Iterator[bytes]:
        """Each frame's bytes in index order (the size from the chunk's
        own header, as FFmpeg reads the chunk)."""
        for pos in self._entries:
            head = self._read(pos, 8)
            if len(head) < 8 or not self._is_frame(head[:4]):
                raise AviError(f"{self.path}: index entry at {pos} is not "
                               f"a chunk of the video stream")
            size = _u32(head, 4)
            data = self._f.read(size)
            if data:
                yield data

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "AviFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
