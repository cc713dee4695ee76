"""``read_image(path, flag)``: the port's ``cv2.imread``.

The file's first bytes pick the decoder, never its name, as cv2 does:
PNG goes to ``io/png``, JPEG to ``io/jpeg`` and BMP to ``io/bmp``, each
bit for bit with cv2 under the three flags the system passes
(``IMREAD_COLOR``, ``IMREAD_GRAYSCALE``, ``IMREAD_UNCHANGED``).  Under
COLOR and GRAYSCALE the EXIF orientation is applied as cv2 applies it: a
JPEG's Exif APP1 segment, a PNG's ``eXIf`` chunk.

- A file ``cv2.imread`` returns None for raises ``FileNotFoundError``
  (missing) or :class:`~fealess_tpu_torch.io.png.DecodeError` (empty, of
  no format cv2 knows, or garbled); callers skip it where the JAX package
  skips a None.
- A file of a format cv2 reads and the port does not (WebP, TIFF, JPEG
  2000, PNM, PFM, EXR, Sun raster, Radiance HDR, GIF, AVIF, JPEG XL), or
  a JPEG or BMP variant its reader leaves out, raises
  :class:`~fealess_tpu_torch.io.jpeg.UnsupportedImage`, which names it.
  No caller skips a frame on that error (``acq`` reports it and returns
  1), so a frame the JAX package would serve is never dropped without a
  word.
- A JPEG or BMP header past OpenCV's size limits (2**30 pixels, 2**20 a
  side) raises ``ValueError``, as ``cv2.imread`` raises ``cv2.error``.
"""

from __future__ import annotations

import zlib

import numpy as np

from fealess_tpu_torch.io import bmp, jpeg, png
from fealess_tpu_torch.io.jpeg import (IMREAD_COLOR, IMREAD_GRAYSCALE,
                                       IMREAD_UNCHANGED, UnsupportedImage)
from fealess_tpu_torch.io.png import DecodeError

__all__ = ["read_image", "image_format", "IMREAD_COLOR", "IMREAD_GRAYSCALE",
           "IMREAD_UNCHANGED", "DecodeError", "UnsupportedImage"]

# signatures of the formats cv2 reads and the port does not
_OTHER = (
    (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"), (b"II+\x00", "BigTIFF"),
    (b"MM\x00+", "BigTIFF"),
    (b"\x00\x00\x00\x0cjP  \r\n\x87\n", "JPEG 2000"),
    (b"\xff\x4f\xff\x51", "JPEG 2000 codestream"),
    (b"\x00\x00\x00\x0cJXL \r\n\x87\n", "JPEG XL"), (b"\xff\x0a", "JPEG XL"),
    (b"v/1\x01", "OpenEXR"), (b"\x59\xa6\x6a\x95", "Sun raster"),
    (b"#?RGBE", "Radiance HDR"), (b"#?RADIANCE", "Radiance HDR"),
    (b"GIF87a", "GIF"), (b"GIF89a", "GIF"),
)


def image_format(head: bytes) -> str:
    """The format the first bytes of a file name: ``"png"``, ``"jpeg"``,
    ``"bmp"``, another format's name, or ``""`` (none cv2 knows)."""
    if head.startswith(png._SIGNATURE):
        return "png"
    if head.startswith(jpeg.SIGNATURE):
        return "jpeg"
    if head.startswith(bmp.SIGNATURE):
        return "bmp"
    for sig, name in _OTHER:
        if head.startswith(sig):
            return name
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        return "WebP"
    if head[4:12] in (b"ftypavif", b"ftypavis"):
        return "AVIF"
    if len(head) >= 3 and head[:1] == b"P" and head[1:2] in b"1234567" \
            and head[2:3].isspace():
        return "PNM"
    if head[:2] in (b"Pf", b"PF") and head[2:3].isspace():
        return "PFM"
    return ""


def png_exif_orientation(data: bytes) -> int:
    """The orientation tag of a PNG's ``eXIf`` chunk as libpng keeps it
    for cv2: the first one whose CRC holds and whose body starts ``II``
    or ``MM`` (before or after the image data); 1 when there is none."""
    for kind, body, crc in png._chunks(data):
        if (kind == b"eXIf" and body[:2] in (b"II", b"MM")
                and zlib.crc32(kind + body) & 0xFFFFFFFF == crc):
            return jpeg.tiff_orientation(body)
        if kind == b"IEND":
            break
    return 1


def read_image(path: str, flag: int = IMREAD_COLOR) -> np.ndarray:
    """Decode ``path`` as ``cv2.imread(path, flag)`` does for ``flag`` in
    ``IMREAD_COLOR``, ``IMREAD_GRAYSCALE`` and ``IMREAD_UNCHANGED``
    (see the module docstring for what raises)."""
    if flag not in (IMREAD_COLOR, IMREAD_GRAYSCALE, IMREAD_UNCHANGED):
        raise ValueError(f"read_image: flag {flag} (the port reads "
                         f"IMREAD_COLOR, IMREAD_GRAYSCALE, IMREAD_UNCHANGED)")
    with open(path, "rb") as f:
        data = f.read()
    kind = image_format(data[:16])
    if kind == "jpeg":
        return jpeg.decode_jpeg(data, flag, path)
    if kind == "bmp":
        return bmp.decode_bmp(data, flag, path)
    if kind == "png":
        if flag == IMREAD_UNCHANGED:
            return png.read_png(path)
        img = (png.read_png_gray(path) if flag == IMREAD_GRAYSCALE
               else png.read_png(path, color=True))
        return jpeg.orient(img, png_exif_orientation(data))
    if kind:
        raise UnsupportedImage(f"{path}: {kind} is read by cv2.imread but "
                               f"not by the port (it reads PNG, JPEG and "
                               f"BMP)")
    raise DecodeError(f"{path}: no image format cv2 reads"
                      + (" (empty file)" if not data else ""))
