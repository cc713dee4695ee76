"""The port's I/O against OpenCV and the JAX package: the stdlib PNG reader
against ``cv2.imread``, the FileStorage YAML reader against
``fealess_tpu.io.linemod_yaml.load_linemod``, and a subprocess check that
the port runs a recognition without jax, flax, cv2 or any module of the
JAX package ``fealess_tpu``."""

import json
import os
import struct
import subprocess
import sys
import zlib

import cv2
import numpy as np
import pytest
import torch

from fealess_tpu import config as cfg
from fealess_tpu.bank import TemplateView as JaxView
from fealess_tpu.io import linemod_yaml as jax_yaml
from fealess_tpu_torch.io import linemod_yaml as port_yaml
from fealess_tpu_torch.io.png import read_png
from tests.test_torch_config import to_port

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "benchmarks", "reference", "out")


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _filter_rows(rows: np.ndarray, bpp: int, filters) -> bytes:
    """(H, stride) u8 packed scanlines, row r filtered with
    ``filters[r % len(filters)]`` (0 None .. 4 Paeth) over ``bpp``-byte
    pixels, each row led by its filter byte."""
    raw = rows.astype(np.int64)
    out = []
    prev = np.zeros(raw.shape[1], np.int64)
    for r in range(raw.shape[0]):
        f = filters[r % len(filters)]
        x = raw[r]
        left = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if f == 0:
            pred = np.zeros_like(x)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        out.append(bytes([f]) + ((x - pred) & 255).astype(np.uint8).tobytes())
        prev = x
    return b"".join(out)


def _png_file(w: int, h: int, depth: int, color: int, data: bytes,
              chunks=(), interlace: int = 0, after=()) -> bytes:
    """PNG bytes around the filtered image data ``data``; ``chunks``
    ((kind, body), ...) go between IHDR and IDAT, ``after`` between IDAT
    and IEND."""
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + b"".join(_chunk(k, b) for k, b in chunks)
            + _chunk(b"IDAT", zlib.compress(data, 1))
            + b"".join(_chunk(k, b) for k, b in after)
            + _chunk(b"IEND", b""))


def _png_bytes(rows: np.ndarray, w: int, depth: int, color: int, bpp: int,
               filters, chunks=(), after=()) -> bytes:
    """PNG bytes of (H, stride) u8 packed scanlines, row r filtered with
    ``filters[r % len(filters)]`` (0 None .. 4 Paeth) over ``bpp``-byte
    pixels; ``chunks`` ((kind, body), ...) go between IHDR and IDAT,
    ``after`` between IDAT and IEND."""
    return _png_file(w, rows.shape[0], depth, color,
                     _filter_rows(rows, bpp, filters), chunks, after=after)


def _encode_png(img: np.ndarray, filters) -> bytes:
    """PNG bytes of a gray (H, W) or RGB (H, W, 3) u8/u16 image, row r
    filtered with ``filters[r % len(filters)]`` (0 None .. 4 Paeth)."""
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else 3
    depth = 16 if img.dtype == np.uint16 else 8
    raw = np.ascontiguousarray(img.astype(">u2" if depth == 16 else np.uint8))
    return _png_bytes(raw.view(np.uint8).reshape(h, -1), w, depth,
                      0 if ch == 1 else 2, ch * depth // 8, filters)


_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def adam7_png(img: np.ndarray, depth=None, color=None, filters=(0,),
              chunks=()) -> bytes:
    """PNG bytes of (H, W) or (H, W, ch) integer samples, Adam7
    interlaced: each of the seven passes (none where it has no pixel)
    packed at ``depth`` bits (default 8, 16 for u16) and its rows filtered
    with ``filters[r % len(filters)]``; ``color`` defaults to gray, gray +
    alpha, RGB or RGBA by the channel count; ``chunks`` go before IDAT."""
    h, w = img.shape[:2]
    samples = img.reshape(h, w, -1)
    ch = samples.shape[2]
    depth = depth or (16 if img.dtype == np.uint16 else 8)
    if color is None:
        color = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    data = b""
    for x0, y0, dx, dy in _ADAM7:
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            data += _filter_rows(
                _pack_samples(sub.reshape(sub.shape[0], -1), depth),
                max(1, ch * depth // 8), filters)
    return _png_file(w, h, depth, color, data, chunks, interlace=1)


def bad_plte_png(h: int, w: int) -> bytes:
    """An 8-bit palette PNG whose PLTE chunk is 8 bytes long, not a multiple
    of 3, which cv2.imread refuses."""
    return _png_bytes(np.zeros((h, w), np.uint8), w, 8, 3, 1, [0],
                      [(b"PLTE", bytes(8))])


def _pack_samples(samples: np.ndarray, depth: int) -> np.ndarray:
    """(H, N) integer samples -> (H, stride) u8 scanlines at ``depth``
    bits, the last byte of a sub-byte row zero-padded."""
    h, n = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.astype(np.uint8)
    bits = (samples[:, :, None] >> np.arange(depth - 1, -1, -1)) & 1
    return np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)


@pytest.mark.parametrize("name", ["scene_bgr.png", "scene_depth.png",
                                  os.path.join("features", "depth", "0.png")])
def test_png_reader_matches_cv2_on_fixture(name):
    path = os.path.join(FIXTURE, name)
    got = read_png(path)
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4],
                                     [4, 3, 2, 1, 0]])
def test_png_reader_filter_types(tmp_path, filters):
    """Every filter type (and rows mixing them) on 8/16-bit gray and RGB,
    against cv2.imread of the same file."""
    rng = np.random.default_rng(11)
    images = [rng.integers(0, 256, (7, 9), dtype=np.uint8),
              rng.integers(0, 256, (6, 5, 3), dtype=np.uint8),
              rng.integers(0, 65536, (5, 8), dtype=np.uint16),
              rng.integers(0, 65536, (4, 6, 3), dtype=np.uint16)]
    for i, img in enumerate(images):
        path = str(tmp_path / f"img{i}.png")
        with open(path, "wb") as f:
            f.write(_encode_png(img, filters))
        got = read_png(path)
        want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        bgr = img if img.ndim == 2 else img[:, :, ::-1]
        np.testing.assert_array_equal(got, bgr)


# colour type, bit depth, palette entries (0: none) and tRNS: each PNG kind
# the reader covers besides 8/16-bit gray and RGB, at an odd width
_KINDS = {"palette8": (3, 8, 11, False), "palette8-trns": (3, 8, 11, True),
          "palette4-trns": (3, 4, 9, True), "palette2": (3, 2, 4, False),
          "palette1-trns": (3, 1, 2, True), "gray-alpha8": (4, 8, 0, False),
          "gray-alpha16": (4, 16, 0, False), "rgba8": (6, 8, 0, False),
          "rgba16": (6, 16, 0, False), "gray1": (0, 1, 0, False),
          "gray2": (0, 2, 0, False), "gray4": (0, 4, 0, False),
          "gray4-trns": (0, 4, 0, True), "rgb8-trns": (2, 8, 0, True),
          "rgb16-trns": (2, 16, 0, True)}


def _kind_samples(kind: str, h: int, w: int, rng):
    """(colour type, bit depth, (h, w * channels) samples, chunks before
    IDAT) of one ``_KINDS`` entry: random samples, a random PLTE, a tRNS
    shorter than the palette or naming the colour (0, 1, 2)."""
    color, depth, n_pal, trns = _KINDS[kind]
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    top = n_pal if color == 3 else 1 << depth
    if trns and color in (0, 2):
        top = 3                    # small values, so the tRNS colour occurs
    samples = rng.integers(0, top, (h, w * ch))
    if color == 2 and w >= 2:
        samples[0, :6] = (0, 0, 1, 0, 1, 2)    # gray 0; the tRNS colour
    chunks = []
    if color == 3:
        chunks.append((b"PLTE", rng.integers(0, 256, (n_pal, 3),
                                             dtype=np.uint8).tobytes()))
        if trns:                   # shorter than the palette: 255 past it
            chunks.append((b"tRNS", rng.integers(
                0, 256, max(1, n_pal - 1), dtype=np.uint8).tobytes()))
    elif trns:
        chunks.append((b"tRNS", struct.pack(">" + "H" * ch, *range(ch))))
    return color, depth, samples, chunks


def _assert_reads_as_cv2(path: str) -> None:
    """read_png, read_png(color=True) and read_png_gray equal cv2.imread
    with IMREAD_UNCHANGED, IMREAD_COLOR and IMREAD_GRAYSCALE."""
    from fealess_tpu_torch.io.png import read_png_gray
    for got, flag in ((read_png(path), cv2.IMREAD_UNCHANGED),
                      (read_png(path, color=True), cv2.IMREAD_COLOR),
                      (read_png_gray(path), cv2.IMREAD_GRAYSCALE)):
        want = cv2.imread(path, flag)
        assert got.dtype == want.dtype and got.shape == want.shape, flag
        np.testing.assert_array_equal(got, want, err_msg=str(flag))


@pytest.mark.parametrize("kind", sorted(_KINDS))
def test_png_reader_kinds_match_cv2(tmp_path, kind):
    """Palette (with and without tRNS), gray+alpha, RGBA, gray at 1/2/4
    bits and RGB/gray with a tRNS colour, 13 columns wide so that sub-byte
    rows end mid-byte, rows through all five filters: read_png equals
    cv2.imread with IMREAD_UNCHANGED, read_png(color=True) with
    IMREAD_COLOR and read_png_gray with IMREAD_GRAYSCALE."""
    h, w = 6, 13
    color, depth, samples, chunks = _kind_samples(
        kind, h, w, np.random.default_rng(sorted(_KINDS).index(kind)))
    ch = samples.shape[1] // w
    path = str(tmp_path / f"{kind}.png")
    with open(path, "wb") as f:
        f.write(_png_bytes(_pack_samples(samples, depth), w, depth, color,
                           max(1, ch * depth // 8), [0, 1, 2, 3, 4],
                           chunks))
    _assert_reads_as_cv2(path)


# every colour type at every bit depth: _KINDS and 8/16-bit gray and RGB
_ADAM7_KINDS = sorted(_KINDS) + ["gray8", "gray16", "rgb8", "rgb16"]


@pytest.mark.parametrize("kind", _ADAM7_KINDS)
def test_png_reader_adam7_matches_cv2(tmp_path, kind):
    """Adam7-interlaced files of every colour type and bit depth (sub-byte
    samples packed per pass, PLTE and tRNS applied after de-interlacing),
    the rows of each pass through all five filters, at sizes where passes
    are empty (1x1, 3x5, 9x2) and at 13x17: read as cv2.imread reads them
    with all three flags."""
    rng = np.random.default_rng(_ADAM7_KINDS.index(kind))
    for h, w in ((1, 1), (3, 5), (9, 2), (13, 17)):
        if kind in _KINDS:
            color, depth, samples, chunks = _kind_samples(kind, h, w, rng)
        else:
            color = 0 if kind.startswith("gray") else 2
            depth = int(kind[4:] if color == 0 else kind[3:])
            samples = rng.integers(0, 1 << depth,
                                   (h, w * (1 if color == 0 else 3)))
            chunks = []
        img = samples.reshape(h, w, -1).astype(
            np.uint16 if depth == 16 else np.uint8)
        path = str(tmp_path / f"{kind}_{h}x{w}.png")
        with open(path, "wb") as f:
            f.write(adam7_png(img, depth, color, [0, 1, 2, 3, 4], chunks))
        _assert_reads_as_cv2(path)


def test_png_gray_rule_matches_cv2(tmp_path):
    """IMREAD_GRAYSCALE of colour PNGs is libpng's fixed-point rule: every
    8-bit RGB triple below 64 (where truncation decides ``> 0`` for masks)
    and random 8- and 16-bit pixels give cv2's gray exactly."""
    from fealess_tpu_torch.io.png import read_png_gray
    rng = np.random.default_rng(5)
    v = np.arange(64 ** 3)
    low = np.stack([v >> 12, (v >> 6) & 63, v & 63], -1).reshape(512, 512, 3)
    cases = [(low, 8), (rng.integers(0, 256, (64, 97, 3)), 8),
             (rng.integers(0, 65536, (64, 97, 3)), 16)]
    for i, (rgb, depth) in enumerate(cases):
        h, w, _ = rgb.shape
        path = str(tmp_path / f"rgb{i}.png")
        with open(path, "wb") as f:
            f.write(_png_bytes(_pack_samples(rgb.reshape(h, -1), depth), w,
                               depth, 2, 3 * depth // 8, [0, 1]))
        np.testing.assert_array_equal(read_png_gray(path),
                                      cv2.imread(path, cv2.IMREAD_GRAYSCALE))


def _gama(value: int):
    return (b"gAMA", struct.pack(">I", value))


_SRGB = (b"sRGB", b"\0")


@pytest.mark.parametrize("chunk", [_gama(45455), _gama(50000),
                                   _gama(220000), _SRGB],
                         ids=["gama45455", "gama50000", "gama220000", "srgb"])
def test_png_gray_gamma_every_triple_matches_cv2(tmp_path, chunk):
    """IMREAD_GRAYSCALE of an 8-bit RGB PNG with a gAMA or sRGB chunk goes
    through libpng's gamma tables: read_png_gray equals cv2 on every one of
    the 2**24 RGB triples (a 4096 x 4096 image), and the gamma changes the
    gray of most of them."""
    from fealess_tpu_torch.io.png import read_png_gray
    v = np.arange(1 << 24, dtype=np.uint32)
    rgb = np.stack([v >> 16, (v >> 8) & 255, v & 255], -1).astype(
        np.uint8).reshape(4096, 4096 * 3)
    del v
    data = np.concatenate([np.zeros((4096, 1), np.uint8), rgb], 1).tobytes()
    path = str(tmp_path / "triples.png")
    with open(path, "wb") as f:
        f.write(_png_file(4096, 4096, 8, 2, data, [chunk]))
    got = read_png_gray(path)
    want = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    np.testing.assert_array_equal(got, want)
    r, g, b = (rgb[:, k::3].astype(np.int32) for k in range(3))
    plain = (9797 * r + 19234 * g + 3737 * b) >> 15
    assert (plain != want).mean() > 0.5


# colour type, bit depth, chunks before IDAT, chunks after IDAT, and whether
# libpng converts in linear light (the chunks it ignores: no)
_PLTE = (b"PLTE", bytes(range(12)))
_GAMMA_FILES = {
    "rgb16-gama45455": (2, 16, [_gama(45455)], [], True),
    "rgb16-gama50000": (2, 16, [_gama(50000)], [], True),
    "rgb16-gama220000": (2, 16, [_gama(220000)], [], True),
    "rgb16-srgb": (2, 16, [_SRGB], [], True),
    "rgb16-sbit12": (2, 16, [(b"sBIT", bytes([12, 12, 12])),
                             _gama(45455)], [], True),
    "rgb16-sbit8": (2, 16, [(b"sBIT", bytes([8, 8, 7])), _gama(45455)], [],
                    True),
    "rgba16-gama45455": (6, 16, [_gama(45455)], [], True),
    "rgba8-gama45455": (6, 8, [_gama(45455)], [], True),
    "palette8-gama45455": (3, 8, [_gama(45455)], [], True),
    "palette4-srgb": (3, 4, [_SRGB], [], True),
    "gray8-gama45455": (0, 8, [_gama(45455)], [], False),
    "gray16-gama45455": (0, 16, [_gama(45455)], [], False),
    "gray-alpha8-gama45455": (4, 8, [_gama(45455)], [], False),
    "rgb8-gama-twice": (2, 8, [_gama(45455), _gama(220000)], [], True),
    "rgb8-gama-then-srgb": (2, 8, [_gama(220000), _SRGB], [], True),
    "rgb8-srgb-then-gama": (2, 8, [_SRGB, _gama(220000)], [], True),
    "rgb8-gama95100": (2, 8, [_gama(95100)], [], True),
    "rgb8-gama3": (2, 8, [_gama(3)], [], True),
    "rgb8-gama96000": (2, 8, [_gama(96000)], [], False),
    "rgb8-gama-after-idat": (2, 8, [], [_gama(45455)], False),
    "rgb8-gama-after-plte": (2, 8, [_PLTE, _gama(45455)], [], False),
    "rgb8-gama-3-bytes": (2, 8, [(b"gAMA", bytes(3))], [], False),
    "rgb8-srgb-intent-4": (2, 8, [(b"sRGB", b"\4")], [], False),
}


@pytest.mark.parametrize("kind", sorted(_GAMMA_FILES))
def test_png_gray_gamma_matches_cv2(tmp_path, kind):
    """read_png_gray equals cv2's IMREAD_GRAYSCALE with gamma chunks:
    16-bit RGB(A) on a seeded 2**20-pixel image (and an sBIT that narrows
    libpng's 16-bit tables), palette and RGBA files with gAMA or sRGB,
    gray files (no conversion, unchanged), and libpng's chunk rules (the
    first gAMA counts, sRGB wins over gAMA in either order, a gAMA within
    5% of 1.0 is ignored unless its reciprocal is not, one below 5 has no
    int32 reciprocal, and a gAMA after IDAT or PLTE, of 3 bytes, or an
    sRGB intent past 3, is ignored); gray pixels (r == g == b) included.
    read_png is unchanged by the chunks."""
    from fealess_tpu_torch.io.png import read_png_gray
    color, depth, chunks, after, linear = _GAMMA_FILES[kind]
    rng = np.random.default_rng(sorted(_GAMMA_FILES).index(kind))
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    h, w = (1024, 1024) if depth == 16 and color == 2 else (64, 97)
    samples = rng.integers(0, 256 if color == 3 else 1 << depth,
                           (h, w, ch))
    if color in (2, 6):
        samples[:h // 8, :, 1:3] = samples[:h // 8, :, :1]   # gray pixels
    if color == 3:
        plte = rng.integers(0, 256, (256, 3), dtype=np.uint8)
        plte[:4, 1:] = plte[:4, :1]          # gray entries
        chunks = chunks + [(b"PLTE", plte[:1 << depth].tobytes())]
        samples %= 1 << depth
    path, bare = str(tmp_path / "gamma.png"), str(tmp_path / "bare.png")
    plain = [c for c in chunks if c[0] == b"PLTE"]
    for name, pre, post in ((path, chunks, after), (bare, plain, [])):
        with open(name, "wb") as f:
            f.write(_png_bytes(_pack_samples(samples.reshape(h, -1), depth),
                               w, depth, color, max(1, ch * depth // 8),
                               [0, 1, 2], pre, post))
    want = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    np.testing.assert_array_equal(read_png_gray(path), want)
    np.testing.assert_array_equal(read_png(path), read_png(bare))
    changed = (want != cv2.imread(bare, cv2.IMREAD_GRAYSCALE)).any()
    assert changed == linear


def test_png_reader_refusals(tmp_path):
    """Files for which cv2.imread returns None raise DecodeError: truncated
    data (progressive, and an Adam7 stream cut in its last pass), a foreign
    file, a palette PNG with a PLTE of 8 bytes and an unknown interlace
    method.  (Adam7 itself is read: test_png_reader_adam7_matches_cv2.)"""
    from fealess_tpu_torch.io.png import DecodeError
    whole = _encode_png(np.arange(64 * 48, dtype=np.uint16).reshape(48, 64),
                        [1])
    img = np.arange(35, dtype=np.uint8).reshape(5, 7)
    rows = b"".join(b"\0" + bytes(r) for r in img)
    for name, data in (("cut_idat", whole[:len(whole) // 2]),
                       ("cut_ihdr", whole[:20]), ("text", b"not a png"),
                       ("bad_plte", bad_plte_png(5, 7)),
                       ("cut_adam7", _png_file(7, 5, 8, 0, rows[:-4],
                                               interlace=1)),
                       ("interlace_2", _png_file(7, 5, 8, 0, rows,
                                                 interlace=2))):
        path = str(tmp_path / f"{name}.png")
        with open(path, "wb") as f:
            f.write(data)
        assert cv2.imread(path, cv2.IMREAD_UNCHANGED) is None
        with pytest.raises(DecodeError):
            read_png(path)


# chunks that libpng ignores (a benign error) or pads, so that cv2 reads
# the image: (colour type, PLTE, tRNS)
_IGNORED = {"rgb-plte-8-bytes": (2, bytes(8), None),
            "gray-plte": (0, bytes(range(12)), None),
            "rgb-trns-4-bytes": (2, None, bytes(4)),
            "palette-trns-past-plte": (3, bytes(range(12)), bytes(5)),
            "palette-trns-empty": (3, bytes(range(12)), b""),
            "palette-index-past-plte": (3, bytes(range(6)), b"\x07")}


@pytest.mark.parametrize("kind", sorted(_IGNORED))
def test_png_reader_ignored_chunks_match_cv2(tmp_path, kind):
    """A PLTE in a gray or RGB file (8 bytes long in the RGB one), a tRNS of
    the wrong length and palette indices past the PLTE entries (black, alpha
    255) read as cv2.imread reads them with all three flags."""
    from fealess_tpu_torch.io.png import read_png_gray
    color, plte, trns = _IGNORED[kind]
    ch = 3 if color == 2 else 1
    samples = np.random.default_rng(len(kind)).integers(0, 4, (4, 5 * ch))
    chunks = [(k, b) for k, b in ((b"PLTE", plte), (b"tRNS", trns))
              if b is not None]
    path = str(tmp_path / f"{kind}.png")
    with open(path, "wb") as f:
        f.write(_png_bytes(_pack_samples(samples, 8), 5, 8, color, ch, [0],
                           chunks))
    for got, flag in ((read_png(path), cv2.IMREAD_UNCHANGED),
                      (read_png(path, color=True), cv2.IMREAD_COLOR),
                      (read_png_gray(path), cv2.IMREAD_GRAYSCALE)):
        want = cv2.imread(path, flag)
        assert got.dtype == want.dtype and got.shape == want.shape, flag
        np.testing.assert_array_equal(got, want, err_msg=str(flag))


def _assert_same_classes(port, ref):
    assert list(port.keys()) == list(ref.keys())
    for cname in ref:
        assert len(port[cname]) == len(ref[cname])
        for a, b in zip(port[cname], ref[cname]):
            assert (a.width, a.height, a.offset_x, a.offset_y) == \
                (b.width, b.height, b.offset_x, b.offset_y)
            assert a.pose.dtype == b.pose.dtype
            np.testing.assert_array_equal(a.pose, b.pose)
            for fl_a, fl_b in zip(a.features, b.features):
                for fa, fb in zip(fl_a, fl_b):
                    assert fa.dtype == fb.dtype and fa.shape == fb.shape
                    np.testing.assert_array_equal(fa, fb)


def test_load_linemod_fixture_equals_jax():
    path = os.path.join(FIXTURE, "features", "linemod_templates.yml")
    det_p, classes_p = port_yaml.load_linemod(path)
    det_j, classes_j = jax_yaml.load_linemod(path)
    assert det_p == to_port(det_j)
    assert len(classes_p["obj"]) == 1024
    _assert_same_classes(classes_p, classes_j)


def test_load_linemod_roundtrip_of_save_linemod(tmp_path):
    """A database written by the JAX package's save_linemod (several
    classes, LINE and LINE-MOD modality sets, odd pose values) reads back
    identically through both loaders."""
    rng = np.random.default_rng(5)
    for det in (cfg.DetectorConfig(t_at_level=(5, 8, 4),
                                   depth_normal=cfg.DepthNormalConfig(
                                       distance_threshold=1500)),
                cfg.default_line()):
        n_mod = len(det.modalities)
        classes = {}
        for cname in ("b_cls", "a_cls", "c-3"):
            views = []
            for _ in range(int(rng.integers(1, 4))):
                feats = [[rng.integers(0, 200, (int(rng.integers(1, 20)), 3))
                          .astype(np.int32) for _ in range(n_mod)]
                         for _ in range(det.pyramid_levels)]
                views.append(JaxView(
                    features=feats,
                    width=[int(v) for v in rng.integers(10, 200,
                                                        det.pyramid_levels)],
                    height=[int(v) for v in rng.integers(10, 200,
                                                         det.pyramid_levels)],
                    offset_x=[int(v) for v in rng.integers(
                        0, 400, det.pyramid_levels)],
                    offset_y=[int(v) for v in rng.integers(
                        0, 300, det.pyramid_levels)],
                    pose=(rng.normal(size=13) * 100).astype(np.float32)))
            classes[cname] = views
        path = str(tmp_path / f"db_{n_mod}.yml")
        jax_yaml.save_linemod(path, det, classes)
        det_p, classes_p = port_yaml.load_linemod(path)
        det_j, classes_j = jax_yaml.load_linemod(path)
        assert det_j == det and det_p == to_port(det)
        _assert_same_classes(classes_p, classes_j)


# Appended to each subprocess script: the names of jax, flax and cv2 and
# of every module of the JAX package or of ``benchmarks`` (the JAX kernel
# lab) that the process loaded, whether by import (``fealess_tpu``,
# ``fealess_tpu.*``, ``benchmarks.*``) or from a file under
# ``fealess_tpu/`` or ``benchmarks/`` (``fealess_tpu_torch`` shares the
# prefix, not the directory).
LOADED = r"""
def _loaded():
    import os
    import fealess_tpu_torch
    repo = os.path.dirname(os.path.dirname(os.path.realpath(
        fealess_tpu_torch.__file__)))
    pkgs = tuple(os.path.join(repo, d) + os.sep
                 for d in ("fealess_tpu", "benchmarks"))
    names = [m for m in ("jax", "flax", "cv2") if m in sys.modules]
    names += sorted(m for m in sys.modules
                    if m.split(".")[0] in ("fealess_tpu", "benchmarks"))
    names += sorted(f for f in (getattr(m, "__file__", None)
                                for m in list(sys.modules.values()))
                    if f and os.path.realpath(f).startswith(pkgs))
    return names
"""

_SUBPROCESS = LOADED + r"""
import json, sys
import numpy as np
import fealess_tpu_torch
from fealess_tpu_torch import config as cfg
from fealess_tpu_torch.apps import fixture, profile_reco, track  # noqa: F401
from fealess_tpu_torch.apps import kernel_lab
from fealess_tpu_torch.ops import lab
from fealess_tpu_torch.parallel import (batch_recon, mesh, multihost,  # noqa: F401
                                        sharded_icp, sharded_match)
from fealess_tpu_torch.engine import CamIntrinsics, ObjReco
from fealess_tpu_torch.tracker.kcf import KcfTracker

frame = np.load(sys.argv[2])
h, w = frame["depth"].shape
ecfg = cfg.EngineConfig(
    detector=cfg.DetectorConfig(image_width=w, image_height=h,
                                max_candidates=8),
    icp=cfg.IcpConfig(max_points=1024), refine_crop=64)
eng = ObjReco.create("LmICP", ecfg, device="cpu")
eng.add_obj(sys.argv[1])
cam = CamIntrinsics(608.0, 608.0, w / 2, h / 2, w, h)
res = eng.recognition(frame["bgr"], frame["depth"], cam)
multi = eng.recognition_multi(frame["bgr"], frame["depth"], cam,
                              max_objects=2)
kcf = KcfTracker(None, "cpu")
_, roi = kcf.update(kcf.init((60, 20, 40, 40), frame["bgr"]), frame["bgr"])
from fealess_tpu_torch.apps import visualize
from fealess_tpu_torch.utils import logging as flog, profiling
flog.get_logger().debug("no jax")
raw = np.full((h, w), 12000, np.uint16)
yy, xx = np.mgrid[10:50, 40:100]
raw[10:50, 40:100] = 7000 + 3 * (xx - 40) + ((xx * yy) % 7) * 20
pose = eng.compute_pose_epnp(raw, 5, 3, np.eye(4, dtype=np.float32), cam)
drawn = visualize.draw_response(frame["bgr"].copy(), eng.bank, 0, (-4, 50))
timer = profiling.StageTimer()
with timer.stage("noop", eng.bank.feat_x):
    pass
lab_rows = kernel_lab.run_coarse(*lab.fixture_like(
    n=4, f=12, nb=3, hd=3, wd=8, c=4, even=True, device="cpu"))
from fealess_tpu_torch.io.imfile import read_image
decoded = [[list(img.shape), img.tobytes().hex()]
           for img in (read_image(p, flag) for p in sys.argv[3:]
                       for flag in (-1, 0, 1))]
print(json.dumps({"decoded": decoded, "n": len(res), "n_multi": len(multi),
                  "roi_ok": bool(np.isfinite(roi).all()),
                  "epnp_ok": bool(np.isfinite(pose).all()),
                  "drawn": bool((drawn != frame["bgr"]).any()),
                  "lab_rows": len(lab_rows),
                  "loaded": _loaded()}))
"""


def test_port_runs_without_jax_flax_or_cv2(tmp_path):
    """A fresh interpreter imports the port (its apps included) and runs a
    small recognition, a multi-object recognition, a KCF update, an EPnP
    pose, a match overlay, the logger, a stage timer and the kernel lab's
    coarse run (``ops/lab``, ``apps/kernel_lab``), and decodes a JPEG
    (progressive, 4:2:0, EXIF orientation 6) and a BMP (8-bit palette)
    written by cv2, as cv2 decodes them under all three flags; jax, flax,
    cv2 and the JAX package (by name or by file) are never loaded."""
    h, w = 80, 160
    rng = np.random.default_rng(2)
    bgr = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    depth = np.full((h, w), 700, np.uint16)
    feats = [[rng.integers(0, 40, (12, 3)).astype(np.int32) % [40, 40, 8]
              for _ in range(2)] for _ in range(2)]
    view = JaxView(features=feats, width=[40, 20], height=[40, 20],
                   offset_x=[30, 15], offset_y=[20, 10],
                   pose=np.eye(3, 4).reshape(-1).tolist() + [700.0])
    view.pose = np.asarray(view.pose, np.float32)
    feat_dir = tmp_path / "features"
    os.makedirs(feat_dir / "depth")
    jax_yaml.save_linemod(str(feat_dir / "linemod_templates.yml"),
                          cfg.DetectorConfig(image_width=w, image_height=h),
                          {"obj": [view]})
    cv2.imwrite(str(feat_dir / "depth" / "0.png"),
                (depth.astype(np.uint32) * 10).astype(np.uint16))
    frame = str(tmp_path / "frame.npz")
    np.savez(frame, bgr=bgr, depth=depth)
    images = [str(tmp_path / "frame.jpg"), str(tmp_path / "frame.bmp")]
    blurred = cv2.GaussianBlur(bgr[:37, :53], (5, 5), 2)
    ok, jpg = cv2.imencode(".jpg", blurred, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    jpg = jpg.tobytes()
    exif = (b"Exif\0\0II*\0\x08\0\0\0\x01\0\x12\x01\x03\0\x01\0\0\0"
            b"\x06\0\0\0\0\0\0\0")
    with open(images[0], "wb") as f:
        f.write(jpg[:2] + b"\xff\xe1" + (len(exif) + 2).to_bytes(2, "big")
                + exif + jpg[2:])
    cv2.imwrite(images[1], bgr[:, :, 0] // 4 * 4)
    want = [[list(img.shape), img.tobytes().hex()]
            for img in (cv2.imread(p, flag) for p in images
                        for flag in (-1, 0, 1))]
    assert want[1][0] == [53, 37]                     # rotated by EXIF
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _SUBPROCESS, str(feat_dir),
                          frame] + images, capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["loaded"] == []
    assert result["n"] in (0, 1)
    assert result["n_multi"] in (0, 1, 2) and result["roi_ok"]
    assert result["epnp_ok"] and result["drawn"]
    assert result["lab_rows"] == 7
    assert result["decoded"] == want
