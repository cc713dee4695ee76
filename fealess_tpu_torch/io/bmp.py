"""A BMP reader on numpy: the counterpart of ``cv2.imread`` on a BMP file
(OpenCV's own ``BmpDecoder``), bit for bit.

Read: the 12-byte OS/2 header and the 40-byte and later Windows headers;
1-, 4- and 8-bit palettes (uncompressed, RLE4 and RLE8); 16 bits as 5-5-5
(``BI_RGB``, or ``BI_BITFIELDS`` with the 555 masks) or 5-6-5
(``BI_BITFIELDS``); 24 bits; 32 bits (``BI_RGB`` or ``BI_BITFIELDS``,
read as B, G, R, A whatever the masks); bottom-up and top-down (negative
height) files, rows padded to 4 bytes.  :func:`decode_bmp` returns what one
``cv2.imread`` flag returns:

- ``IMREAD_COLOR``: u8 BGR (H, W, 3); 5-bit and 6-bit fields are shifted
  up to 8 bits with zeros below, alpha is dropped;
- ``IMREAD_GRAYSCALE``: u8 (H, W) by OpenCV's fixed-point BGR to gray,
  (1868 B + 9617 G + 4899 R + 8192) >> 14, of the BGR value (for a
  palette, of each entry);
- ``IMREAD_UNCHANGED``: gray (H, W) for a palette whose entries are all
  gray and for every OS/2 file (the decoder never calls those colour),
  BGRA (H, W, 4) for 32-bit ``BI_BITFIELDS``, else BGR (H, W, 3).

RLE follows the decoder's own rules: pixels passed over by an end of
line, a delta or an end of bitmap take palette entry 0; RLE8 wraps a run
that ends a row onto the next row, so an end of line right after it adds
no row, and its end of bitmap fills the rest of the image; RLE4's end of
bitmap ends the row and reading goes on.  A file the decoder refuses or
cannot read to its end, or whose run crosses the end of its row
(``cv2.imread``: None), raises
:class:`~fealess_tpu_torch.io.png.DecodeError`.
"""

from __future__ import annotations

import struct

import numpy as np

from fealess_tpu_torch.io.jpeg import (IMREAD_COLOR, IMREAD_GRAYSCALE,
                                       UnsupportedImage, check_size)
from fealess_tpu_torch.io.png import DecodeError

SIGNATURE = b"BM"
_RGB, _RLE8, _RLE4, _BITFIELDS = 0, 1, 2, 3
# OpenCV's BGR -> gray weights (SCALE 14)
_CB, _CG, _CR = 1868, 9617, 4899


def _gray(bgr: np.ndarray) -> np.ndarray:
    b, g, r = (bgr[..., i].astype(np.int32) for i in range(3))
    return ((b * _CB + g * _CG + r * _CR + 8192) >> 14).astype(np.uint8)


class _Stream:
    """OpenCV's RLByteStream over the file's bytes: a read past the end
    raises (the decoder's exception; ``cv2.imread`` returns None)."""

    def __init__(self, data: bytes, pos: int, path: str):
        self.data, self.pos, self.path = data, pos, path

    def read(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise DecodeError(f"{self.path}: BMP data ends early")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.read(1)[0]


def _header(data: bytes, path: str):
    """(width, height, bpp (15 for 5-5-5), compression, palette (256, 4)
    B G R x or None, is colour, pixel offset, the R G B A masks of a
    32-bit ``BI_BITFIELDS`` file whose header holds them, or None)."""
    if len(data) < 18 or not data.startswith(SIGNATURE):
        raise DecodeError(f"{path} is not a BMP file")
    s = _Stream(data, 10, path)
    offset, size = struct.unpack("<iI", s.read(8))
    palette = masks = None
    iscolor = False
    if size >= 36:
        width, height, _, bpp, comp = struct.unpack("<iiHHI", s.read(16))
        if comp > _BITFIELDS:
            raise DecodeError(f"{path}: BMP compression {comp}")
        s.read(12)
        clrused = struct.unpack("<i", s.read(4))[0]
        s.pos = 14 + size
        ok = width > 0 and height != 0 and (
            (bpp in (1, 4, 8, 24, 32) and comp == _RGB)
            or (bpp in (16, 32) and comp in (_RGB, _BITFIELDS))
            or (bpp == 4 and comp == _RLE4) or (bpp == 8 and comp == _RLE8))
        if not ok:
            raise DecodeError(f"{path}: BMP of {bpp} bits with compression "
                              f"{comp} (or size {width}x{height})")
        iscolor = True
        if bpp == 32 and comp == _BITFIELDS and size >= 56:
            masks = struct.unpack("<IIII", data[54:70])
        if bpp <= 8:
            if not 0 <= clrused <= 256:
                raise DecodeError(f"{path}: {clrused} palette entries")
            n = clrused or 1 << bpp
            palette = np.zeros((256, 4), np.uint8)
            palette[:n] = np.frombuffer(s.read(4 * n), np.uint8).reshape(n, 4)
            pal = palette[:1 << bpp]
            iscolor = bool(((pal[:, 0] != pal[:, 1])
                            | (pal[:, 0] != pal[:, 2])).any())
        elif bpp == 16 and comp == _BITFIELDS:
            r, g, b = struct.unpack("<III", s.read(12))
            if (b, g, r) == (0x1F, 0x3E0, 0x7C00):
                bpp = 15
            elif (b, g, r) != (0x1F, 0x7E0, 0xF800):
                raise DecodeError(f"{path}: 16-bit BMP masks {r:#x} "
                                  f"{g:#x} {b:#x}")
        elif bpp == 16:
            bpp = 15
    elif size == 12:
        width, height, _, bpp = struct.unpack("<HHHH", s.read(8))
        comp = _RGB
        if not (width > 0 and height != 0 and bpp in (1, 4, 8, 24, 32)):
            raise DecodeError(f"{path}: OS/2 BMP of {bpp} bits")
        if bpp <= 8:
            n = 1 << bpp
            palette = np.zeros((256, 4), np.uint8)
            palette[:n, :3] = np.frombuffer(s.read(3 * n),
                                            np.uint8).reshape(n, 3)
    else:
        raise DecodeError(f"{path}: BMP header of {size} bytes")
    return width, height, bpp, comp, palette, iscolor, offset, masks


def _channels(flag: int, bpp: int, comp: int, iscolor: bool) -> int:
    if flag == IMREAD_GRAYSCALE:
        return 1
    if flag == IMREAD_COLOR:
        return 3
    if not iscolor:
        return 1
    return 4 if bpp == 32 and comp == _BITFIELDS else 3


def _masked(px: np.ndarray, masks, nch: int, path: str) -> np.ndarray:
    """32-bit pixels (h, w, 4) by the header's R G B A masks, each 8
    contiguous bits on a byte (alpha 0: opaque): BGRA, BGR, or gray as
    OpenCV 5 makes it from them, trunc(0.299 R + 0.587 G + 0.114 B) in
    float32."""
    v = px.view("<u4")[..., 0]
    chans = []
    for m in masks:
        if m == 0 and len(chans) == 3:
            chans.append(np.full(v.shape, 255, np.uint8))
            continue
        if m not in (0xFF, 0xFF00, 0xFF0000, 0xFF000000):
            raise UnsupportedImage(f"{path}: 32-bit BMP with the channel "
                                   f"mask {m:#x} is read by cv2.imread but "
                                   f"not by the port")
        chans.append(((v & m) >> (m.bit_length() - 8)).astype(np.uint8))
    r, g, b, a = chans
    if nch == 1:
        f = np.float32
        y = (f(0.299) * r.astype(f) + f(0.587) * g.astype(f)
             + f(0.114) * b.astype(f))
        return y.astype(np.uint8)[..., None]
    return np.stack([b, g, r, a][:nch], -1)


def _unpack(rows: np.ndarray, width: int, bpp: int) -> np.ndarray:
    """(h, pitch) bytes -> (h, width) palette indices, high bits first."""
    bits = np.unpackbits(rows, axis=1)[:, :width * bpp]
    bits = bits.reshape(rows.shape[0], width, bpp)
    return (bits @ (1 << np.arange(bpp - 1, -1, -1))).astype(np.uint8)


def _plain(s: _Stream, w: int, h: int, bpp: int, nch: int, palette,
           masks=None):
    """The uncompressed pixel rows, in file order, as (h, w, nch)."""
    pitch = ((w * (16 if bpp == 15 else bpp) + 7) // 8 + 3) & -4
    rows = np.frombuffer(s.read(pitch * h), np.uint8).reshape(h, pitch)
    if bpp <= 8:
        idx = _unpack(rows, w, bpp) if bpp < 8 else rows[:, :w]
        bgr = palette[idx][..., :3]
        return bgr if nch == 3 else _gray(bgr)[..., None]
    if bpp in (15, 16):
        t = rows[:, :2 * w].view("<u2").astype(np.int32)
        if bpp == 15:
            bgr = np.stack([(t << 3) & 0xF8, (t >> 2) & 0xF8,
                            (t >> 7) & 0xF8], -1)
        else:
            bgr = np.stack([(t << 3) & 0xF8, (t >> 3) & 0xFC,
                            (t >> 8) & 0xF8], -1)
        bgr = bgr.astype(np.uint8)
        return bgr if nch == 3 else _gray(bgr)[..., None]
    px = rows[:, :w * (bpp // 8)].reshape(h, w, bpp // 8)
    if masks is not None:
        return _masked(px, masks, nch, s.path)
    if nch == 4:
        return px
    return px[..., :3] if nch == 3 else _gray(px[..., :3])[..., None]


def _rle(s: _Stream, w: int, h: int, bpp: int, nch: int, palette):
    """RLE4 / RLE8 as OpenCV's decoder walks them: (h, w, nch) in file
    order (row 0 is the first decoded row)."""
    colors = palette[:, :3] if nch == 3 else _gray(palette[:, :3])[:, None]
    out = np.zeros((h, w, nch), np.uint8)
    fill0 = colors[0]
    flat = out.reshape(-1, nch)
    y, x = 0, 0                      # the write position: row, column

    def fill(count: int) -> None:
        """FillUniColor with palette entry 0: ``count`` pixels on from
        (y, x), moving to the next row at each row end (also at once when
        the row is already full)."""
        nonlocal y, x
        while True:
            n = min(count, w - x)
            flat[y * w + x:y * w + x + n] = fill0
            x += n
            count -= n
            if x >= w:
                y, x = y + 1, 0
                if y >= h:
                    return
            if count <= 0:
                return

    def crossing(n: int) -> None:
        if x + n > w:
            raise DecodeError(f"{s.path}: an RLE run crosses its row's end")

    if bpp == 8:
        row_ended = False            # OpenCV's line_end_flag
        while True:
            length, code = s.read(2)
            if length:
                crossing(length)
                prev = y
                flat[y * w + x:y * w + x + length] = colors[code]
                x += length
                if x >= w:           # the run ends the row: wrap
                    y, x = y + 1, 0
                row_ended = y != prev
                if y >= h:
                    break
            elif code > 2:           # absolute
                crossing(code)
                idx = np.frombuffer(s.read((code + 1) & ~1), np.uint8)
                flat[y * w + x:y * w + x + code] = colors[idx[:code]]
                x += code
                row_ended = False
                if y >= h:
                    break
            else:
                if code or not row_ended or x > 0:
                    count, dy = w - x, h - y
                    if code == 2:
                        count, dy = s.byte(), s.byte()
                    if code:
                        count += dy * w
                    if y >= h:
                        break
                    fill(count)
                row_ended = False
                if y >= h:
                    break
        return out
    while True:                      # RLE4
        length, code = s.read(2)
        if length:
            crossing(length)
            pair = colors[[code >> 4, code & 15]]
            flat[y * w + x:y * w + x + length] = pair[np.arange(length) & 1]
            x += length
        elif code > 2:
            crossing(code)
            raw = np.frombuffer(s.read((((code + 1) >> 1) + 1) & ~1), np.uint8)
            idx = np.stack([raw >> 4, raw & 15], -1).reshape(-1)[:code]
            flat[y * w + x:y * w + x + code] = colors[idx]
            x += code
        else:
            count = w - x
            if code == 2:
                count = s.byte()
                s.byte()
            fill(count)
            if y >= h:
                break
    return out


def decode_bmp(data: bytes, flag: int = IMREAD_COLOR,
               path: str = "<bytes>") -> np.ndarray:
    """Decode BMP bytes as ``cv2.imread(path, flag)`` does (see the module
    docstring)."""
    w, h, bpp, comp, palette, iscolor, offset, masks = _header(data, path)
    check_size(w, abs(h), path)
    nch = _channels(flag, bpp, comp, iscolor)
    if offset < 0:
        raise DecodeError(f"{path}: BMP pixel offset {offset}")
    s = _Stream(data, offset, path)
    bottom_up = h > 0
    h = abs(h)
    if comp in (_RLE4, _RLE8):
        img = _rle(s, w, h, bpp, nch, palette)
    else:
        img = _plain(s, w, h, bpp, nch, palette, masks)
    if bottom_up:
        img = img[::-1]
    return np.ascontiguousarray(img[..., 0] if nch == 1 else img)

