"""Image files and printf patterns as ``cv2.VideoCapture`` opens them:
FFmpeg's ``image2`` demuxer and its image pipes, each frame decoded by
the FFmpeg decoder cv2 reaches and converted to BGR24 by swscale, bit for
bit.

- A path with one printf field (``%d``, ``%0Nd`` or ``%Nd``, both
  zero-padded; ``%%`` is a literal ``%``) is a sequence
  (:func:`frame_filename` is ``av_get_frame_filename``).  Its first
  number is the first of 0-4 whose file exists (no file: cv2 does not
  open the path), and its frames run from there to the first number whose
  file is missing (``find_image_range``, then ``img_read_packet``'s error
  on the missing file, after which every read fails).  The codec is the
  extension's (``ff_guess_image2_codec``, case-insensitive): a file whose
  content is of another format is a packet the decoder rejects.
- A single image file is one frame, its codec picked by content (the pipe
  demuxers' probes; the whole file is the packet).

The frame decoders (:func:`png_frame`, :func:`bmp_frame`; JPEG goes to
:mod:`~fealess_tpu_torch.io.mjpeg`, FFmpeg's ``mjpeg`` decoder, not to
``io/jpeg``, which is libjpeg's):

- PNG: FFmpeg's ``png`` decoder then swscale to BGR24, which equal
  ``cv2.imread(IMREAD_COLOR)``'s pixels at 8 bits and below (gray, gray
  with alpha, RGB, RGBA, palette, ``tRNS``; alpha dropped); 16-bit gray
  (with or without alpha) goes to 8 bits as min((v + 128) >> 8, 255).
  16-bit RGB(A) goes through swscale's dithered 16-to-8 bit conversion,
  which the port does not reproduce, and swscale refuses the frame of an
  Adam7-interlaced PNG (cv2 then hands on a buffer it did not convert):
  both raise :class:`~fealess_tpu_torch.io.video.UnsupportedVideo`.  A
  chunk cut short before ``IEND`` fails the frame, as FFmpeg's decoder
  fails it (a file that simply ends before ``IEND`` decodes).  No
  EXIF orientation is applied (cv2's FFmpeg path applies none to an
  image).
- BMP: FFmpeg's ``bmp`` decoder, equal to ``cv2.imread(IMREAD_COLOR)``
  for the 1-, 4-, 8-, 24- and 32-bit kinds and RLE; a 16-bit file
  (swscale repeats each field's top bits below it), an RLE file with a
  delta escape (FFmpeg's msrle moves it otherwise) and a file whose pixel
  data ``cv2.imread`` cannot read to its end (FFmpeg decodes it) are
  refused by name.
- JPEG: no EXIF orientation (checked against cv2 5.0.0); a
  ``CS=ITU601`` comment switches the decoder to limited range for the
  rest of the sequence, as in a Motion JPEG stream.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np

from fealess_tpu_torch.io import bmp, png
from fealess_tpu_torch.io.jpeg import IMREAD_COLOR, UnsupportedImage
from fealess_tpu_torch.io.png import DecodeError

# ff_img_tags (libavformat/img2.c): extension -> codec; "png", "mjpeg"
# and "bmp" are the decoders the port has, the others are named when
# refused
EXTENSION_CODECS = {
    "jpeg": "mjpeg", "jpg": "mjpeg", "jps": "mjpeg", "mpo": "mjpeg",
    "ljpg": "lossless JPEG", "jls": "JPEG-LS", "png": "png", "pns": "png",
    "mng": "png", "ppm": "PPM", "pnm": "PPM", "pgm": "PGM",
    "pgmyuv": "PGMYUV", "pbm": "PBM", "pam": "PAM", "pfm": "PFM",
    "phm": "PHM", "cri": "CRI", "pix": "Alias PIX", "dds": "DDS",
    "mpg1-img": "MPEG-1", "mpg2-img": "MPEG-2", "mpg4-img": "MPEG-4",
    "y": "raw video", "raw": "raw video", "bmp": "bmp", "tga": "Targa",
    "tiff": "TIFF", "tif": "TIFF", "dng": "TIFF", "sgi": "SGI",
    "ptx": "PTX", "pcd": "Photo CD", "pcx": "PCX", "pic": "QuickDraw",
    "pct": "QuickDraw", "pict": "QuickDraw", "sun": "Sun raster",
    "ras": "Sun raster", "rs": "Sun raster", "im1": "Sun raster",
    "im8": "Sun raster", "im24": "Sun raster", "im32": "Sun raster",
    "sunras": "Sun raster", "svg": "SVG", "svgz": "SVG",
    "j2c": "JPEG 2000", "jp2": "JPEG 2000", "jpc": "JPEG 2000",
    "j2k": "JPEG 2000", "dpx": "DPX", "exr": "OpenEXR", "yuv10": "V210X",
    "webp": "WebP", "xbm": "XBM", "xpm": "XPM", "xface": "XFace",
    "xwd": "XWD", "img": "GEM", "ximg": "GEM", "timg": "GEM",
    "vbn": "VBN", "jxl": "JPEG XL", "qoi": "QOI", "hdr": "Radiance HDR",
    "wbmp": "WBMP", "gif": "GIF",
}
DECODED = ("png", "mjpeg", "bmp")
_START_RANGE = 5          # image2's start_number 0, start_number_range 5


def frame_filename(pattern: str, number: int) -> Optional[str]:
    """``av_get_frame_filename`` (one field only): ``pattern`` with its
    ``%d`` / ``%0Nd`` / ``%Nd`` field set to ``number``, or None where it
    has no field, two, or a ``%`` FFmpeg does not take."""
    out, i, found = [], 0, False
    while i < len(pattern):
        c = pattern[i]
        i += 1
        if c != "%":
            out.append(c)
            continue
        width = 0
        while True:            # digits, then the conversion (FFmpeg's loop)
            while i < len(pattern) and pattern[i].isdigit():
                width = width * 10 + int(pattern[i])
                i += 1
            if i >= len(pattern):
                return None
            c = pattern[i]
            i += 1
            if not c.isdigit():
                break
        if c == "%":
            out.append("%")
        elif c == "d" and not found:
            found = True
            out.append(f"{number:0{width}d}")
        else:
            return None
    return "".join(out) if found else None


def is_pattern(path: str) -> bool:
    return frame_filename(path, 1) is not None


def extension_codec(path: str) -> Optional[str]:
    """The codec ``ff_guess_image2_codec`` gives the path's extension."""
    base = os.path.basename(path)
    if "." not in base:
        return None
    return EXTENSION_CODECS.get(base.rsplit(".", 1)[1].lower())


def _exists(path: str) -> bool:
    return os.path.isfile(path) and os.access(path, os.R_OK)


def find_range(pattern: str) -> Optional[Tuple[int, int]]:
    """``find_image_range``: the first number of 0-4 whose file exists and
    the last one its doubling probe reaches, or None."""
    for first in range(_START_RANGE):
        if _exists(frame_filename(pattern, first)):
            break
    else:
        return None
    last = first
    while True:
        step = 0
        while True:
            nxt = 1 if not step else 2 * step
            if not _exists(frame_filename(pattern, last + nxt)):
                break
            step = nxt
            if step >= 1 << 30:
                return None
        if not step:
            return first, last
        last += step


def sequence_files(pattern: str) -> Iterator[str]:
    """The files an image2 sequence reads, in order: from the first number
    to the first missing file (which ends the stream)."""
    found = find_range(pattern)
    if found is None:
        return
    for n in range(found[0], found[1] + 1):
        name = frame_filename(pattern, n)
        if not _exists(name):
            return
        yield name


def jpeg_frame_end(data: bytes, start: int = 0) -> int:
    """Where FFmpeg's mjpeg parser ends the frame that starts at
    ``start`` (``find_frame_end`` from a fresh state: the frame's SOI, then
    the next SOI followed by a marker, segment payloads stepped over), or
    -1 where the data ends first."""
    state, size, i, found = 0, 0, start, False
    n = len(data)
    while i < n:
        state = ((state << 8) | data[i]) & 0xFFFFFFFF
        if 0xFFC00000 <= state <= 0xFFFEFFFF:
            if 0xFFD8FFC0 <= state <= 0xFFD8FFFF:
                if found:
                    return i - 3
                found = True
                i += 1
                continue
            if state < 0xFFD00000 or state > 0xFFD9FFFF:
                size = (state & 0xFFFF) - 1
        if size > 0:
            step = min(n - i, size)
            i += step
            size -= step
            state = 0
            continue
        i += 1
    return -1


def jpeg_packets(data: bytes) -> List[bytes]:
    """JPEG images back to back (raw Motion JPEG) cut as FFmpeg's mjpeg
    parser cuts them: each packet from where the last one ended up to the
    next frame's SOI."""
    out, at = [], 0
    while at < len(data):
        end = jpeg_frame_end(data, at)
        if end < 0:
            out.append(data[at:])
            break
        out.append(data[at:end])
        at = end
    return out


def png_packets(data: bytes) -> List[bytes]:
    """PNG images back to back cut as FFmpeg's png parser (``png_pipe``)
    cuts them: a packet runs from where the last one ended through the
    next PNG signature and its chunks to the end of its ``IEND`` chunk; a
    chunk length past 2**31 - 1 sends the parser back to the signature
    search; the rest of the data is the last packet."""
    out, at, start, n = [], 0, 0, len(data)
    while at < n:
        found = data.find(png._SIGNATURE, at)
        if found < 0:
            break
        at = found + 8
        while at + 8 <= n:                     # chunk length, type
            length, kind = struct.unpack_from(">I4s", data, at)
            if length > 0x7FFFFFFF:
                at += 4
                break
            at += 8 + length + 4
            if kind == b"IEND":
                if at <= n:
                    out.append(data[start:at])
                    start = at
                break
        else:
            break
    if start < n:
        out.append(data[start:])
    return out


def _check_chunks(data: bytes, what: str) -> None:
    """FFmpeg's png decoder walks the chunks to ``IEND`` or to the end of
    the packet, and fails the frame at a chunk cut short (its length,
    type, data or CRC past the end): raise DecodeError there."""
    at = 8
    while at < len(data):
        left = len(data) - at
        length = struct.unpack_from(">I", data, at)[0] if left >= 4 else 0
        if left < 12 or length > 0x7FFFFFFF or length + 12 > left:
            raise DecodeError(f"{what}: a PNG chunk cut short at byte {at}")
        if data[at + 4:at + 8] == b"IEND":
            return
        at += 12 + length


def png_frame(data: bytes, what: str = "<frame>") -> np.ndarray:
    """A PNG as FFmpeg's ``png`` decoder and swscale give it to cv2: BGR u8
    (H, W, 3) (see the module docstring)."""
    data = bytes(data)
    if data.startswith(png._SIGNATURE) and len(data) > 28 and \
            data[12:16] == b"IHDR" and data[28] == 1:
        # swscale refuses the decoder's frame here ("Invalid argument")
        # and cv2 hands on a buffer it did not convert
        raise UnsupportedImage(f"{what}: an Adam7-interlaced PNG, which "
                               f"swscale does not convert under cv2")
    _check_chunks(data, what)
    img, _, _ = png.decode_bytes(data, what)
    if img.dtype == np.uint16:
        if img.shape[2] >= 3:
            raise UnsupportedImage(
                f"{what}: 16-bit colour PNG through swscale's dithered "
                f"16-to-8 bit conversion")
        img = np.minimum((img[:, :, :1].astype(np.uint32) + 128) >> 8,
                         255).astype(np.uint8)
    if img.shape[2] <= 2:
        return np.repeat(img[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(img[:, :, 2::-1])


def _rle_delta(data: bytes, at: int, bpp: int) -> bool:
    """Whether the RLE4 / RLE8 stream at ``at`` holds a delta escape
    before its end of bitmap."""
    while at + 2 <= len(data):
        count, code = data[at], data[at + 1]
        at += 2
        if count:
            continue
        if code == 1:
            return False
        if code == 2:
            return True
        if code > 2:                  # an absolute run, padded to 16 bits
            n = code if bpp == 8 else (code + 1) // 2
            at += n + (n & 1)
    return False


def bmp_frame(data: bytes, what: str = "<frame>") -> np.ndarray:
    """A BMP as FFmpeg's ``bmp`` decoder and swscale give it to cv2."""
    if len(data) >= 34 and data.startswith(bmp.SIGNATURE) and \
            struct.unpack_from("<I", data, 14)[0] >= 40:
        bpp, comp = struct.unpack_from("<HI", data, 28)
        if bpp == 16:
            # FFmpeg's rgb555 / rgb565 to BGR24 repeats each field's top
            # bits below it; cv2.imread fills zeros
            raise UnsupportedImage(f"{what}: 16-bit BMP through swscale's "
                                   f"rgb555 / rgb565 conversion")
        if comp in (1, 2) and _rle_delta(
                data, struct.unpack_from("<I", data, 10)[0], bpp):
            # FFmpeg's msrle moves a delta otherwise than cv2.imread
            raise UnsupportedImage(f"{what}: RLE BMP with a delta escape "
                                   f"through FFmpeg's msrle decoder")
    bmp._header(bytes(data), what)        # DecodeError where FFmpeg fails
    try:
        return bmp.decode_bmp(bytes(data), IMREAD_COLOR, what)
    except DecodeError as e:
        # pixel data cut short, or RLE past a row or without its end of
        # bitmap: cv2.imread gives None, FFmpeg's decoder a frame
        raise UnsupportedImage(f"{what}: a BMP whose pixel data cv2.imread "
                               f"cannot read to its end ({e}) is read by "
                               f"FFmpeg's bmp decoder") from None
