"""The port's ``read_image`` (``io/imfile``: PNG, JPEG and BMP by content)
held bit for bit to ``cv2.imread`` under ``IMREAD_COLOR``,
``IMREAD_GRAYSCALE`` and ``IMREAD_UNCHANGED``.

JPEG files come from ``cv2.imencode`` on seeded numpy images (blurred
noise, so the chroma is smooth, and raw noise): qualities 50/95/100, every
sampling factor cv2 writes, progressive and sequential, Huffman
optimisation, restart intervals 0/1/7, one-channel sources, sizes 1x1 to
480x640; EXIF orientations 1-8 in an APP1 segment built here; files cut
short; JPEG data under a ``.png`` name.  BMP files come from cv2 (8, 24 and
32 bits) and from headers built here (1/4/8-bit palettes, OS/2 headers,
16-bit 555/565, 32 bits with and without masks, RLE4/RLE8 with ends of
line, deltas and early ends of bitmap, top-down).  Every kind the port
leaves out raises ``UnsupportedImage``; every file cv2 returns None for
raises ``DecodeError`` (or ``FileNotFoundError``).  The committed files
of ``tests/data/torch_frames`` (which ``chip_smoke.py`` decodes on the
card) are held to their recorded digests and to cv2 here."""

import hashlib
import json
import os
import struct
import threading
import zlib

import cv2
import numpy as np
import pytest

from fealess_tpu_torch.io import imfile
from fealess_tpu_torch.io.imfile import (DecodeError, UnsupportedImage,
                                         read_image)
from tests.make_torch_frames import (OUT, build_bmp, padded_rows, rle4, rle8,
                                     smooth_image, with_exif)

FLAGS = (cv2.IMREAD_UNCHANGED, cv2.IMREAD_GRAYSCALE, cv2.IMREAD_COLOR)
SAMPLING = {"411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}
SIZES = [(1, 1), (7, 9), (17, 33), (480, 640)]


def _write(tmp_path, name: str, blob: bytes) -> str:
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(blob)
    return path


def _same_as_cv2(path: str, flags=FLAGS) -> list:
    """read_image equals cv2.imread under each flag; returns the arrays."""
    out = []
    for flag in flags:
        want = cv2.imread(path, flag)
        assert want is not None, (path, flag)
        got = read_image(path, flag)
        assert (got.dtype, got.shape) == (want.dtype, want.shape), flag
        np.testing.assert_array_equal(got, want, err_msg=f"flag {flag}")
        out.append(got)
    return out


def _jpeg(img, *params) -> bytes:
    ok, buf = cv2.imencode(".jpg", img, list(params))
    assert ok
    return buf.tobytes()


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("progressive", [0, 1], ids=["seq", "prog"])
@pytest.mark.parametrize("quality", [50, 95, 100])
@pytest.mark.parametrize("rst", [0, 1, 7], ids=lambda r: f"rst{r}")
def test_jpeg_matrix_matches_cv2(tmp_path, size, sampling, progressive,
                                 quality, rst):
    rng = np.random.default_rng(quality + 7 * rst + 100 * progressive)
    img = smooth_image(rng, *size)
    blob = _jpeg(img, cv2.IMWRITE_JPEG_QUALITY, quality,
                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
                 cv2.IMWRITE_JPEG_PROGRESSIVE, progressive,
                 cv2.IMWRITE_JPEG_RST_INTERVAL, rst)
    _same_as_cv2(_write(tmp_path, "x.jpg", blob))


@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("progressive", [0, 1], ids=["seq", "prog"])
def test_jpeg_raw_noise_matches_cv2(tmp_path, sampling, progressive):
    """Unblurred noise at quality 100: the IDCT's output far from the
    middle of its range and sharp chroma edges for the upsampler."""
    img = np.random.default_rng(3).integers(0, 256, (40, 56, 3), np.uint8)
    blob = _jpeg(img, cv2.IMWRITE_JPEG_QUALITY, 100,
                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
                 cv2.IMWRITE_JPEG_PROGRESSIVE, progressive)
    _same_as_cv2(_write(tmp_path, "x.jpg", blob))


@pytest.mark.parametrize("optimize", [0, 1])
@pytest.mark.parametrize("progressive", [0, 1], ids=["seq", "prog"])
@pytest.mark.parametrize("sampling", ["420", "444"])
def test_jpeg_optimized_tables_match_cv2(tmp_path, optimize, progressive,
                                         sampling):
    img = smooth_image(np.random.default_rng(5), 45, 61)
    blob = _jpeg(img, cv2.IMWRITE_JPEG_OPTIMIZE, optimize,
                 cv2.IMWRITE_JPEG_PROGRESSIVE, progressive,
                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling])
    _same_as_cv2(_write(tmp_path, "x.jpg", blob))


def test_jpeg_luma_chroma_quality_matches_cv2(tmp_path):
    img = smooth_image(np.random.default_rng(6), 33, 47)
    blob = _jpeg(img, cv2.IMWRITE_JPEG_LUMA_QUALITY, 30,
                 cv2.IMWRITE_JPEG_CHROMA_QUALITY, 85)
    _same_as_cv2(_write(tmp_path, "x.jpg", blob))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("progressive", [0, 1], ids=["seq", "prog"])
def test_jpeg_one_channel_matches_cv2(tmp_path, size, progressive):
    """A gray source (one component): (H, W) under UNCHANGED and
    GRAYSCALE, replicated to BGR under COLOR."""
    img = smooth_image(np.random.default_rng(7), *size, channels=1)
    path = _write(tmp_path, "x.jpg", _jpeg(img, cv2.IMWRITE_JPEG_PROGRESSIVE,
                                           progressive))
    unchanged, gray, color = _same_as_cv2(path)
    assert unchanged.shape == size and color.shape == size + (3,)


def test_jpeg_gray_is_libjpegs_y_not_bgr2gray(tmp_path):
    """IMREAD_GRAYSCALE of a colour JPEG is Y as decoded, which differs
    from BGR2GRAY of the colour decode."""
    img = np.random.default_rng(8).integers(0, 256, (64, 64, 3), np.uint8)
    path = _write(tmp_path, "x.jpg", _jpeg(img))
    _, gray, color = _same_as_cv2(path)
    assert (gray != cv2.cvtColor(color, cv2.COLOR_BGR2GRAY)).any()


@pytest.mark.parametrize("order", ["II", "MM"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_jpeg_exif_orientation_matches_cv2(tmp_path, orientation, order):
    """Orientations 1-8 applied under COLOR and GRAYSCALE as cv2 applies
    them, never under UNCHANGED."""
    img = smooth_image(np.random.default_rng(9), 37, 53)
    path = _write(tmp_path, "x.jpg", with_exif(_jpeg(img), orientation,
                                               order))
    unchanged, gray, color = _same_as_cv2(path)
    assert unchanged.shape == (37, 53, 3)
    assert color.shape[:2] == ((53, 37) if orientation >= 5 else (37, 53))


@pytest.mark.parametrize("case", ["other-app1-first", "not-exif", "two-exif",
                                  "after-sof", "bad-value"])
def test_jpeg_exif_segment_choice_matches_cv2(tmp_path, case):
    """The first APP1 segment that starts ``Exif\\0\\0`` counts (before
    the first scan); others are passed over; values past 8 do nothing."""
    jpg = _jpeg(smooth_image(np.random.default_rng(10), 37, 53))

    def app1(body):
        return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body

    exif6 = with_exif(jpg, 6)[2:-len(jpg) + 2]           # the segment alone
    exif3 = with_exif(jpg, 3)[2:-len(jpg) + 2]
    if case == "other-app1-first":
        blob = jpg[:2] + app1(b"http://ns.adobe.com/xap/1.0/\0<x/>") + \
            exif6 + jpg[2:]
    elif case == "not-exif":
        blob = jpg[:2] + app1(b"Exifxx" + exif6[10:]) + jpg[2:]
    elif case == "two-exif":
        blob = jpg[:2] + exif3 + exif6 + jpg[2:]
    elif case == "after-sof":
        sos = jpg.find(b"\xff\xda")
        blob = jpg[:sos] + exif6 + jpg[sos:]
    else:
        blob = with_exif(jpg, 9)
    _same_as_cv2(_write(tmp_path, "x.jpg", blob))


@pytest.mark.parametrize("cut", [0.3, 0.6, 0.9, 0.995])
@pytest.mark.parametrize("rst", [0, 5], ids=lambda r: f"rst{r}")
def test_jpeg_cut_short_matches_cv2(tmp_path, cut, rst):
    """Entropy data that ends early: the blocks after it decode as zero
    coefficients (flat gray), as libjpeg leaves them."""
    img = smooth_image(np.random.default_rng(11), 64, 80)
    blob = _jpeg(img, cv2.IMWRITE_JPEG_RST_INTERVAL, rst)
    _same_as_cv2(_write(tmp_path, "x.jpg", blob[:int(len(blob) * cut)]))


def test_jpeg_without_eoi_matches_cv2(tmp_path):
    blob = _jpeg(smooth_image(np.random.default_rng(12), 30, 30))
    _same_as_cv2(_write(tmp_path, "x.jpg", blob[:-2]))


@pytest.mark.parametrize("name", ["x.png", "x.bmp", "x", "x.JPG"])
def test_read_by_content_not_by_name(tmp_path, name):
    """JPEG bytes under any name decode as cv2 decodes them (cv2 picks the
    decoder by the first bytes); so do BMP bytes under a ``.jpg`` name and
    PNG bytes under a ``.bmp`` name."""
    img = smooth_image(np.random.default_rng(13), 21, 35)
    _same_as_cv2(_write(tmp_path, name, _jpeg(img)))
    bmp = cv2.imencode(".bmp", img)[1].tobytes()
    _same_as_cv2(_write(tmp_path, "b.jpg", bmp))
    png = cv2.imencode(".png", img)[1].tobytes()
    _same_as_cv2(_write(tmp_path, "p.bmp", png))


@pytest.mark.parametrize("ids", ["RGB", "adobe0", "adobe1"])
def test_jpeg_component_colour_space_matches_cv2(tmp_path, ids):
    """Three components without a JFIF marker: RGB by the ids 'R' 'G' 'B'
    or by an Adobe marker with transform 0, YCbCr with transform 1."""
    img = smooth_image(np.random.default_rng(14), 24, 40)
    blob = bytearray(_jpeg(img, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                           SAMPLING["444"]))
    app0 = blob.find(b"\xff\xe0")
    length = struct.unpack(">H", blob[app0 + 2:app0 + 4])[0]
    del blob[app0:app0 + 2 + length]
    if ids == "RGB":
        sof, sos = blob.find(b"\xff\xc0"), blob.find(b"\xff\xda")
        for k in range(3):
            blob[sof + 10 + 3 * k] = b"RGB"[k]
            blob[sos + 5 + 2 * k] = b"RGB"[k]
    else:
        body = b"Adobe" + bytes([0, 100, 0, 0, 0, 0, int(ids[-1])])
        blob[2:2] = b"\xff\xee" + struct.pack(">H", len(body) + 2) + body
    _same_as_cv2(_write(tmp_path, "x.jpg", bytes(blob)))


def _png_with_exif(img, body: bytes, where: str = "before") -> bytes:
    png = cv2.imencode(".png", img)[1].tobytes()
    chunk = (struct.pack(">I", len(body)) + b"eXIf" + body
             + struct.pack(">I", zlib.crc32(b"eXIf" + body) & 0xFFFFFFFF))
    at = png.find(b"IDAT" if where == "before" else b"IEND") - 4
    return png[:at] + chunk + png[at:]


@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("where", ["before", "after"])
def test_png_exif_orientation_matches_cv2(tmp_path, orientation, where):
    """A PNG's eXIf chunk (before or after the image data) turns the image
    under COLOR and GRAYSCALE as cv2 turns it."""
    img = np.random.default_rng(15).integers(0, 256, (5, 7, 3), np.uint8)
    tiff = with_exif(b"\xff\xd8", orientation)[10:]
    _same_as_cv2(_write(tmp_path, "x.png", _png_with_exif(img, tiff, where)))


# ---- BMP


@pytest.mark.parametrize("size", [(1, 1), (7, 9), (17, 33), (5, 3)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_bmp_from_cv2_matches_cv2(tmp_path, size, channels):
    """cv2's own BMPs: 8-bit gray palette, 24 bits, 32 bits (a V5 header
    with masks: BGRA under UNCHANGED, float gray)."""
    img = np.random.default_rng(16).integers(0, 256, size + (4,), np.uint8)
    img = img[:, :, 0] if channels == 1 else img[:, :, :channels]
    _same_as_cv2(_write(tmp_path, "x.bmp",
                        cv2.imencode(".bmp", img)[1].tobytes()))


def _bmp_case(kind: str) -> bytes:
    rng = np.random.default_rng(17)
    w, h = 13, 7
    if kind.startswith(("pal", "os2pal", "v5pal", "clrused")):
        bpp = int(kind.rsplit("_", 1)[1])
        n = 1 << bpp
        pal = rng.integers(0, 256, (n, 4))
        if "gray" in kind:
            pal[:, 1] = pal[:, 2] = pal[:, 0]
        idx = rng.integers(0, n, (h, w))
        bits = ((idx[..., None] >> np.arange(bpp - 1, -1, -1)) & 1).astype(
            np.uint8).reshape(h, -1)
        rows = [np.packbits(r).tobytes() for r in bits]
        data = padded_rows(rows[::-1], ((w * bpp + 7) // 8 + 3) & -4)
        if kind.startswith("os2"):
            return build_bmp(w, h, bpp, data, palette=pal, hsize=12)
        if kind.startswith("v5"):
            return build_bmp(w, h, bpp, data, palette=pal, hsize=124)
        if kind.startswith("clrused"):
            pal = pal[:max(1, n // 2)]
        return build_bmp(w, h, bpp, data, palette=pal)
    if kind.startswith("16"):
        v = rng.integers(0, 65536, (h, w)).astype("<u2")
        data = padded_rows([r.tobytes() for r in v[::-1]], (2 * w + 3) & -4)
        masks = {"16_555": None, "16_555bf": (0x7C00, 0x3E0, 0x1F),
                 "16_565bf": (0xF800, 0x7E0, 0x1F)}[kind]
        return build_bmp(w, h, 16, data, comp=0 if masks is None else 3,
                         masks=masks)
    if kind in ("24", "24_topdown", "24_os2", "32", "32_topdown", "32_os2",
                "32_bf40"):
        bpp = int(kind[:2])
        px = rng.integers(0, 256, (h, w, bpp // 8), np.uint8)
        rows = [r.tobytes() for r in px]
        top = kind.endswith("topdown")
        data = padded_rows(rows if top else rows[::-1],
                           (w * bpp // 8 + 3) & -4)
        if kind.endswith("os2"):
            return build_bmp(w, h, bpp, data, hsize=12)
        if kind == "32_bf40":
            return build_bmp(w, h, 32, data, comp=3,
                             masks=(0xFF0000, 0xFF00, 0xFF))
        return build_bmp(w, h, bpp, data, topdown=top)
    if kind.startswith("32_v5"):
        masks = {"32_v5_bgra": (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
                 "32_v5_noalpha": (0xFF0000, 0xFF00, 0xFF, 0),
                 "32_v5_rgba": (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
                 "32_v5_argb": (0xFF000000, 0xFF0000, 0xFF00, 0xFF)}[kind]
        px = rng.integers(0, 256, (h, w, 4), np.uint8)
        blob = bytearray(build_bmp(w, h, 32, px[::-1].tobytes(), comp=3,
                                   hsize=124))
        blob[54:70] = struct.pack("<IIII", *masks)
        return bytes(blob)
    # RLE: rows of indices in file order; a delta (3 right, 1 down) after
    # a run of 5, then a run to the row's end (RLE8 wraps to the next row
    # there; RLE4 needs an end of line, and its delta moves along the row
    # only)
    if kind.startswith("rle8"):
        pal = rng.integers(0, 256, (256, 4))
        idx = rng.integers(0, 4, (h, w))
        idx[:, :5] = 3
        data = {"rle8": rle8(idx), "rle8_topdown": rle8(idx),
                "rle8_early_eob": rle8(idx[:3]),
                "rle8_delta": b"\5\1\0\2\3\1\5\2" + rle8(idx[2:])}[kind]
        return build_bmp(w, h, 8, data, comp=1, palette=pal,
                         topdown=kind.endswith("topdown"))
    pal = rng.integers(0, 256, (16, 4))
    idx = rng.integers(0, 16, (h, w))
    idx[:, 2:8] = 5
    data = {"rle4": rle4(idx),
            "rle4_delta": b"\5\x12\0\2\3\1\5\x34\0\0" + rle4(idx[1:])
            }[kind]
    return build_bmp(w, h, 4, data, comp=2, palette=pal)


BMP_KINDS = ([f"pal_{b}" for b in (1, 4, 8)]
             + [f"palgray_{b}" for b in (1, 4, 8)]
             + [f"os2pal_{b}" for b in (1, 4, 8)]
             + ["v5pal_8", "clrused_8", "clrused_4", "16_555", "16_555bf",
                "16_565bf", "24", "24_topdown", "24_os2", "32", "32_topdown",
                "32_os2", "32_bf40", "32_v5_bgra", "32_v5_noalpha",
                "32_v5_rgba", "32_v5_argb", "rle8", "rle8_early_eob",
                "rle8_delta", "rle8_topdown", "rle4", "rle4_delta"])


@pytest.mark.parametrize("kind", BMP_KINDS)
def test_bmp_built_matches_cv2(tmp_path, kind):
    _same_as_cv2(_write(tmp_path, "x.bmp", _bmp_case(kind)))


@pytest.mark.parametrize("kind", ["masks_444", "short_rows", "rle8_cross",
                                  "rle4_cross", "rle8_no_eob",
                                  "rle4_early_eob", "bad_compression",
                                  "header_size"])
def test_bmp_cv2_refuses_is_decode_error(tmp_path, kind):
    """Files cv2's BMP decoder refuses or cannot read to the end (RLE8
    without its end of bitmap after an absolute run; RLE4, whose end of
    bitmap only ends the row, reads on past it)."""
    rng = np.random.default_rng(18)
    px = rng.integers(0, 256, (7, 13, 3), np.uint8)
    rows = padded_rows([r.tobytes() for r in px[::-1]], (13 * 3 + 3) & -4)
    v = rng.integers(0, 65536, (7, 13)).astype("<u2")
    pal = rng.integers(0, 256, (256, 4))
    idx = rng.integers(0, 4, (7, 13))
    blob = {
        "masks_444": build_bmp(13, 7, 16, padded_rows(
            [r.tobytes() for r in v], 28), comp=3, masks=(0xF00, 0xF0, 0xF)),
        "short_rows": build_bmp(13, 7, 24, rows)[:-1],
        "rle8_cross": build_bmp(13, 7, 8, bytes([14, 2]) + rle8(
            rng.integers(0, 4, (7, 13))), comp=1, palette=pal),
        "rle4_cross": build_bmp(13, 7, 4, bytes([14, 0x12]) + rle4(
            rng.integers(0, 16, (7, 13))), comp=2, palette=pal[:16]),
        "rle8_no_eob": build_bmp(13, 7, 8, rle8(idx)[:-2], comp=1,
                                 palette=pal),
        "rle4_early_eob": build_bmp(13, 7, 4, rle4(idx[:3]), comp=2,
                                    palette=pal[:16]),
        "bad_compression": build_bmp(13, 7, 24, rows, comp=4),
        "header_size": build_bmp(13, 7, 24, rows)[:14] + struct.pack(
            "<I", 20) + build_bmp(13, 7, 24, rows)[18:],
    }[kind]
    path = _write(tmp_path, "x.bmp", blob)
    for flag in FLAGS:
        assert cv2.imread(path, flag) is None
        with pytest.raises(DecodeError):
            read_image(path, flag)


# ---- what the port leaves out, and what cv2 returns None for


def _sof_only(marker: int, precision: int = 8, components: int = 3) -> bytes:
    body = struct.pack(">BHHB", precision, 8, 8, components)
    body += b"".join(bytes([i + 1, 0x11, 0]) for i in range(components))
    return (b"\xff\xd8" + bytes([0xFF, marker])
            + struct.pack(">H", len(body) + 2) + body + b"\xff\xd9")


def _refused_jpeg(kind: str) -> bytes:
    img = smooth_image(np.random.default_rng(19), 64, 80)
    if kind == "arithmetic":
        return _sof_only(0xC9)
    if kind == "lossless":
        return _sof_only(0xC3)
    if kind == "hierarchical":
        return _sof_only(0xC5)
    if kind == "12-bit":
        return _sof_only(0xC1, precision=12)
    if kind == "cmyk":
        return _sof_only(0xC0, components=4)
    if kind == "default-tables":
        blob = bytearray(_jpeg(img))
        while (at := blob.find(b"\xff\xc4")) >= 0:
            length = struct.unpack(">H", blob[at + 2:at + 4])[0]
            del blob[at:at + 2 + length]
        return bytes(blob)
    blob = _jpeg(img, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    return blob[:len(blob) // 2]                      # block smoothing


@pytest.mark.parametrize("kind", ["arithmetic", "lossless", "hierarchical",
                                  "12-bit", "cmyk", "default-tables",
                                  "progressive-cut-short"])
def test_left_out_jpeg_kinds_raise_unsupported(tmp_path, kind):
    path = _write(tmp_path, "x.jpg", _refused_jpeg(kind))
    if kind in ("default-tables", "progressive-cut-short"):
        assert cv2.imread(path) is not None               # cv2 reads these
    for flag in FLAGS:
        with pytest.raises(UnsupportedImage):
            read_image(path, flag)


OTHER_FORMATS = [(".tiff", "TIFF"), (".webp", "WebP"),
                 (".ppm", "PNM"), (".pgm", "PNM"),
                 (".pfm", "PFM"), (".ras", "Sun raster"),
                 (".hdr", "Radiance HDR"), (".gif", "GIF"),
                 (".avif", "AVIF")]


@pytest.mark.parametrize("ext,name", OTHER_FORMATS)
def test_other_formats_raise_unsupported(tmp_path, ext, name):
    """Formats cv2 reads and the port does not raise UnsupportedImage with
    the format's name, whatever the file is called."""
    img = smooth_image(np.random.default_rng(20), 16, 24)
    if ext == ".pgm":
        img = img[:, :, 0]
    if ext in (".pfm", ".hdr"):
        img = img.astype(np.float32) / 255
    ok, buf = cv2.imencode(ext, img)
    if not ok:
        pytest.fail(f"cv2 cannot write {ext}")
    path = _write(tmp_path, "frame.png", buf.tobytes())
    assert cv2.imread(path, cv2.IMREAD_UNCHANGED) is not None
    for flag in FLAGS:
        with pytest.raises(UnsupportedImage, match=name):
            read_image(path, flag)


@pytest.mark.parametrize("sig,name", [(b"v/1\x01", "OpenEXR"),
                                      (b"\x00\x00\x00\x0cJXL \r\n\x87\n",
                                       "JPEG XL"), (b"MM\x00*", "TIFF"),
                                      (b"\x00\x00\x00\x0cjP  \r\n\x87\n",
                                       "JPEG 2000")])
def test_other_signatures_are_named(sig, name):
    assert imfile.image_format(sig + bytes(8)) == name


def _huge_jpeg(side: int) -> bytes:
    """A JPEG whose frame header says side x side, its scan cut short."""
    blob = bytearray(_jpeg(smooth_image(np.random.default_rng(23), 16, 16)))
    sof = blob.find(b"\xff\xc0")
    blob[sof + 5:sof + 9] = side.to_bytes(2, "big") * 2
    return bytes(blob)


@pytest.mark.parametrize("kind", ["empty", "garbage", "jpeg-garbage",
                                  "png-garbage", "bmp-garbage", "sof-only",
                                  "no-scan", "jpeg-past-65500"])
def test_unreadable_files_are_decode_errors(tmp_path, kind):
    """Files cv2.imread returns None for raise DecodeError; a missing file
    raises FileNotFoundError."""
    jpg = _jpeg(smooth_image(np.random.default_rng(21), 16, 16))
    blob = {"empty": b"", "garbage": b"hello world, no image",
            "jpeg-garbage": b"\xff\xd8\xff" + bytes(100),
            "png-garbage": b"\x89PNG\r\n\x1a\n" + bytes(40),
            "bmp-garbage": b"BM" + bytes(10),
            "sof-only": _sof_only(0xC0),
            "no-scan": jpg[:jpg.find(b"\xff\xda")] + b"\xff\xd9",
            "jpeg-past-65500": _huge_jpeg(65535)}[kind]
    path = _write(tmp_path, "x.jpg", blob)
    for flag in FLAGS:
        assert cv2.imread(path, flag) is None
        with pytest.raises(DecodeError):
            read_image(path, flag)
    with pytest.raises(FileNotFoundError):
        read_image(str(tmp_path / "missing.jpg"))


@pytest.mark.parametrize("kind", ["jpeg", "bmp"])
def test_sizes_past_cv2_limits_raise(tmp_path, kind):
    """A header past OpenCV's 2**30 pixels: cv2.imread raises (it does not
    return None), and so does read_image, before allocating the image;
    the error is not a DecodeError, so no caller skips the frame."""
    blob = (_huge_jpeg(60000) if kind == "jpeg" else build_bmp(
        1 << 16, 1 << 15, 8, b"\0\1", comp=1, palette=np.zeros((2, 4))))
    path = _write(tmp_path, "x." + kind, blob)
    with pytest.raises(cv2.error):
        cv2.imread(path)
    for flag in FLAGS:
        with pytest.raises(ValueError, match="limits") as info:
            read_image(path, flag)
        assert not isinstance(info.value, DecodeError)


def test_decoder_threads_agree(tmp_path):
    """The C decoder is called from several threads at once (a frame
    loader's) and gives each the same image."""
    img = smooth_image(np.random.default_rng(22), 240, 320)
    paths = [_write(tmp_path, f"{i}.jpg", _jpeg(
        img, cv2.IMWRITE_JPEG_PROGRESSIVE, i % 2)) for i in range(4)]
    want = [cv2.imread(p) for p in paths]
    errors = []

    def work(k):
        for _ in range(5):
            if not np.array_equal(read_image(paths[k % 4]), want[k % 4]):
                errors.append(k)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors


# ---- the committed files chip_smoke.py decodes on the card

with open(os.path.join(OUT, "digests.json")) as _f:
    DIGESTS = json.load(_f)


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_committed_digests_equal_cv2(name):
    """Each committed file's recorded digests equal cv2.imread's here and
    read_image's, under every flag."""
    path = os.path.join(OUT, name)
    for flag in FLAGS:
        want = cv2.imread(path, flag)
        digest = [list(want.shape),
                  hashlib.sha256(want.tobytes()).hexdigest()]
        assert DIGESTS[name][str(flag)] == digest, (name, flag)
        got = read_image(path, flag)
        assert [list(got.shape), hashlib.sha256(
            got.tobytes()).hexdigest()] == digest, (name, flag)


def test_committed_files_cover_the_kinds():
    """The set chip_smoke decodes: every sampling factor, progressive,
    restart, gray, EXIF 6 and 8, odd sizes, a cut file, JPEG under a PNG
    name, BMP 8/24/32 and RLE8, the 640x480 series; well under 300 KB."""
    names = set(DIGESTS)
    assert {f"s{s}.jpg" for s in SAMPLING} <= names
    assert {"progressive.jpg", "restart.jpg", "gray.jpg", "exif6.jpg",
            "exif8.jpg", "odd_1x1.jpg", "odd_7x9.jpg", "truncated.jpg",
            "jpeg_named.png", "bmp8.bmp", "bmp24.bmp", "bmp32.bmp",
            "rle8.bmp"} <= names
    assert {f"series/gray/{i}.png" for i in range(3)} <= names
    total = sum(os.path.getsize(os.path.join(root, f))
                for root, _, files in os.walk(OUT) for f in files)
    assert total < 300_000
