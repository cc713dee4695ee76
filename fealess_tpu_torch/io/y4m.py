"""A YUV4MPEG2 (``.y4m``) demuxer: the frames FFmpeg's ``yuv4mpegpipe``
demuxer hands to the ``rawvideo`` decoder under ``cv2.VideoCapture``
(:mod:`~fealess_tpu_torch.io.rawvideo` converts them).

- The stream header is one line of at most 128 bytes, its newline
  included: ``YUV4MPEG2`` and tokens, read as ``yuv4_read_header`` reads
  them from the eleventh byte on: ``W`` and ``H`` (``strtol``; both
  needed and positive), ``C`` (the colour space, matched by prefix in
  FFmpeg's order: :data:`COLOUR_SPACES`), ``I`` (``p`` and ``?``
  progressive, ``t`` and ``b`` interlaced; any other stops the open), ``F``
  and ``A`` (rate and aspect, which change no pixel) and ``X``
  extensions (``XYSCSS=``, the colour space where no ``C`` token gives
  one, and ``XCOLORRANGE=FULL`` / ``LIMITED``).  ``cv2.VideoWriter``
  writes ``C420jpeg`` with ``XYSCSS=420JPEG``, whatever the fourcc.
- Each frame is a ``FRAME`` line of at most 80 bytes (its parameters are
  skipped) and the frame's planes with no padding.  A line that does not
  start ``FRAME`` or has no newline in 80 bytes, and a frame cut short,
  end the stream (cv2's ``read`` returns False there).

Read: 4:2:0 (``C420jpeg``, ``C420``, ``C420mpeg2`` and ``C420paldv``, or
no ``C`` token) and ``Cmono``.  A header ``yuv4_read_header`` refuses
raises :class:`Y4mError` (cv2 does not open the file); a colour space of
another subsampling or depth, an interlaced stream (swscale refuses its
frames under cv2) and 4:2:0 sited left or top-left at an odd height (cv2
converts it with that siting through swscale's scaler) raise
:class:`UnsupportedY4m`, which names it.
"""

from __future__ import annotations

import re
from typing import BinaryIO, Iterator

from fealess_tpu_torch.io.rawvideo import frame_size

MAGIC = b"YUV4MPEG2"
MAX_HEADER = 128
MAX_FRAME_HEADER = 80

# yuv4mpegdec's C values in the order it tries them: (prefix, FFmpeg's
# pixel format, chroma siting); "yuv420p" and "gray" are read
COLOUR_SPACES = (
    ("420jpeg", "yuv420p", "center"), ("420mpeg2", "yuv420p", "left"),
    ("420paldv", "yuv420p", "topleft"), ("420p16", "yuv420p16", ""),
    ("422p16", "yuv422p16", ""), ("444p16", "yuv444p16", ""),
    ("420p14", "yuv420p14", ""), ("422p14", "yuv422p14", ""),
    ("444p14", "yuv444p14", ""), ("420p12", "yuv420p12", ""),
    ("422p12", "yuv422p12", ""), ("444p12", "yuv444p12", ""),
    ("420p10", "yuv420p10", ""), ("422p10", "yuv422p10", ""),
    ("444p10", "yuv444p10", ""), ("420p9", "yuv420p9", ""),
    ("422p9", "yuv422p9", ""), ("444p9", "yuv444p9", ""),
    ("420", "yuv420p", "center"), ("411", "yuv411p", ""),
    ("422", "yuv422p", ""), ("444alpha", "yuva444p", ""),
    ("444", "yuv444p", ""), ("mono16", "gray16", ""),
    ("mono12", "gray12", ""), ("mono10", "gray10", ""),
    ("mono9", "gray9", ""), ("mono", "gray", ""))
# the XYSCSS= values, in the order FFmpeg tries them
_YSCSS = (("420JPEG", "yuv420p"), ("420MPEG2", "yuv420p"),
          ("420PALDV", "yuv420p"), ("420P9", "yuv420p9"),
          ("422P9", "yuv422p9"), ("444P9", "yuv444p9"),
          ("420P10", "yuv420p10"), ("422P10", "yuv422p10"),
          ("444P10", "yuv444p10"), ("420P12", "yuv420p12"),
          ("422P12", "yuv422p12"), ("444P12", "yuv444p12"),
          ("420P14", "yuv420p14"), ("422P14", "yuv422p14"),
          ("444P14", "yuv444p14"), ("420P16", "yuv420p16"),
          ("422P16", "yuv422p16"), ("444P16", "yuv444p16"),
          ("411", "yuv411p"), ("422", "yuv422p"), ("444", "yuv444p"))
READ = ("yuv420p", "gray")
_INT = re.compile(rb"\s*[+-]?\d+")


class Y4mError(ValueError):
    """A YUV4MPEG2 header FFmpeg refuses: cv2 does not open the file."""


class UnsupportedY4m(ValueError):
    """A YUV4MPEG2 stream cv2 reads and the port does not: the message
    names what."""


def is_y4m(head: bytes) -> bool:
    return head.startswith(MAGIC)


def _strtol(line: bytes, at: int):
    """(value, end) of ``strtol`` at ``at`` (0 and ``at`` where no digits
    follow)."""
    m = _INT.match(line, at)
    if not m:
        return 0, at
    return int(m.group()), m.end()


class Y4mFile:
    """The YUV4MPEG2 stream at ``path``: :attr:`width`, :attr:`height`,
    :attr:`fmt` (``"yuv420p"`` or ``"gray"``), :attr:`full_range` and
    :meth:`frames`.  Close it (or use it as a context manager)."""

    def __init__(self, path: str):
        self.path = path
        self._f: BinaryIO = open(path, "rb")
        try:
            self._read_header()
        except BaseException:
            self._f.close()
            raise

    def _read_header(self) -> None:
        line = self._f.read(MAX_HEADER)
        end = line.find(b"\n")
        if end < 0:
            raise Y4mError(f"{self.path}: no YUV4MPEG2 header line in "
                           f"{MAX_HEADER} bytes")
        if not line.startswith(MAGIC):
            raise Y4mError(f"{self.path}: not a YUV4MPEG2 stream")
        self._f.seek(end + 1)
        line = line[:end] + b" "
        width = height = -1
        cspace = yscss = None
        interlace, full_range = b"p", False
        at = len(MAGIC) + 1
        while at < len(line):            # yuv4_read_header's token loop
            c = line[at:at + 1]
            if c == b" ":
                at += 1
                continue
            at += 1
            if c == b"W":
                width, at = _strtol(line, at)
            elif c == b"H":
                height, at = _strtol(line, at)
            elif c == b"C":
                cspace = next((s for s in COLOUR_SPACES
                               if line.startswith(s[0].encode(), at)), None)
                if cspace is None:
                    raise Y4mError(
                        f"{self.path}: YUV4MPEG2 colour space "
                        f"{line[at - 1:line.find(b' ', at)].decode('latin-1')}"
                        f" (FFmpeg knows none such)")
                at = line.find(b" ", at)
            elif c == b"I":
                interlace = line[at:at + 1]
                at += 1
                if interlace not in (b"p", b"?", b"t", b"b"):
                    raise Y4mError(f"{self.path}: YUV4MPEG2 interlacing "
                                   f"I{interlace.decode('latin-1')}")
            elif c in (b"F", b"A"):
                at = line.find(b" ", at)
            elif c == b"X":
                if line.startswith(b"YSCSS=", at):
                    yscss = next((f for name, f in _YSCSS
                                  if line.startswith(name.encode(), at + 6)),
                                 yscss)
                elif line.startswith(b"COLORRANGE=", at):
                    if line.startswith(b"FULL", at + 11):
                        full_range = True
                    elif line.startswith(b"LIMITED", at + 11):
                        full_range = False
                at = line.find(b" ", at)
            at += 1
        if width <= 0 or height <= 0 or \
                (width + 128) * (height + 128) >= (2 ** 31 - 1) // 8:
            raise Y4mError(f"{self.path}: YUV4MPEG2 frame size "
                           f"{width}x{height}")
        fmt, siting = (cspace[1], cspace[2]) if cspace else (
            yscss or "yuv420p", "")
        what = f"{self.path}: YUV4MPEG2"
        if fmt not in READ:
            raise UnsupportedY4m(f"{what} of {fmt} (C{cspace[0]})"
                                 if cspace else f"{what} of {fmt} (XYSCSS)")
        if interlace in (b"t", b"b"):
            raise UnsupportedY4m(f"{what} interlaced (I"
                                 f"{interlace.decode()}: swscale refuses its "
                                 f"frames under cv2)")
        if siting in ("left", "topleft") and height & 1:
            raise UnsupportedY4m(
                f"{what} with C{cspace[0]} at an odd height ({height}: cv2 "
                f"converts it through swscale's scaler with that chroma "
                f"siting)")
        self.width, self.height, self.fmt = width, height, fmt
        self.full_range = full_range
        self.frame_size = frame_size(width, height, fmt)

    def frames(self) -> Iterator[bytes]:
        """Each frame's planes, in order, up to the first ``FRAME`` line
        FFmpeg refuses or the first frame cut short."""
        while True:
            line = self._f.read(MAX_FRAME_HEADER)
            end = line.find(b"\n")
            if end < 0 or not line.startswith(b"FRAME"):
                return
            self._f.seek(self._f.tell() - len(line) + end + 1)
            data = self._f.read(self.frame_size)
            if len(data) < self.frame_size:
                return
            yield data

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "Y4mFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
