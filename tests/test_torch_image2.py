"""Image files and printf patterns through the port's ``io/video.
VideoReader`` (``io/image2``) against ``cv2.VideoCapture`` and the JAX
package: FFmpeg's image2 rules for a pattern (the field forms, the first
number in 0-4, the run to the first missing file), single PNG, BMP and JPEG
files decoded as FFmpeg's decoders and swscale give them (not as
``cv2.imread`` does where the two differ), the kinds still refused by name,
the read at which cv2 first returns False, and ``acquire_series`` from one
image and from a pattern equal to JAX's."""

import contextlib
import io
import os
import struct

import cv2
import numpy as np
import pytest

from fealess_tpu.apps import acquire as jax_acquire
from fealess_tpu.io.series import ImageSeriesReader as JaxReader
from fealess_tpu_torch.apps import acquire
from fealess_tpu_torch.io import image2
from fealess_tpu_torch.io.series import ImageSeriesReader
from fealess_tpu_torch.io.video import UnsupportedVideo, VideoReader
from tests.make_torch_frames import with_exif
from tests.make_torch_video import (cv2_frames, jpeg, mux_avi, scene,
                                    write_cv2_clip)
from tests.test_torch_imfile import BMP_KINDS, _bmp_case
from tests.test_torch_io import _png_file

S, Q = cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_QUALITY


def jax_reads(path: str) -> list:
    """The port's frames up to the first read cv2 fails, as the JAX
    reader takes them."""
    with VideoReader(path) as reader:
        return list(reader)


def same_as_cv2(path: str) -> int:
    """Assert the port's frames equal cv2's, as many; return the count."""
    want = cv2_frames(path)
    got = jax_reads(path)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, i
        np.testing.assert_array_equal(g, w, err_msg=f"frame {i}")
    return len(want)


def _write(path, data: bytes) -> str:
    os.makedirs(os.path.dirname(str(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
    return str(path)


@pytest.mark.parametrize("pattern,number,want", [
    ("f_%d.png", 7, "f_7.png"), ("f_%03d.png", 7, "f_007.png"),
    ("f_%3d.png", 12, "f_012.png"), ("a%%_%d.png", 1, "a%_1.png"),
    ("%d", 0, "0"), ("f_%d_%d.png", 1, None), ("f.png", 1, None),
    ("100%.png", 1, None), ("f_%x.png", 1, None), ("f_%", 1, None)])
def test_frame_filename_is_ffmpegs(pattern, number, want):
    """av_get_frame_filename: one %d field, zero-padded widths, %% a
    literal; anything else is no pattern."""
    assert image2.frame_filename(pattern, number) == want


@pytest.mark.parametrize("numbers", [(0, 1, 2), (5, 6), (3, 4, 5, 7),
                                     (0, 1, 2, 4, 8), (4, 5, 6), (1,),
                                     (2, 3, 9), (0, 2, 3)])
def test_pattern_start_and_gap_match_cv2(tmp_path, numbers):
    """The first number is the first of 0-4 whose file exists; the frames
    run to the first missing number (FFmpeg's doubling probe reaches past
    gaps, and the read of the missing file ends the stream); with no file
    in 0-4 neither cv2 nor the port opens the path."""
    frames = scene(32, 24, 3, 10)
    for n in numbers:
        cv2.imwrite(str(tmp_path / f"f_{n}.png"), frames[n])
    pattern = str(tmp_path / "f_%d.png")
    if not any(n < 5 for n in numbers):
        assert cv2_frames(pattern) == []
        with pytest.raises(OSError, match="cannot open video source"):
            VideoReader(pattern)
        with pytest.raises(OSError, match="cannot open video source"):
            JaxReader(pattern)
        return
    run = 0
    first = min(numbers)
    while first + run in numbers:
        run += 1
    assert same_as_cv2(pattern) == run


@pytest.mark.parametrize("form", ["%03d", "%3d", "%d", "upper", "percent"])
def test_pattern_forms_match_cv2(tmp_path, form):
    """Zero-padded fields (%3d pads with zeros, as %03d), a field that
    does not match the names (no frames: not opened), an upper-case
    extension, a literal %%."""
    frames = scene(24, 16, 4, 3)
    name, pattern = {
        "%03d": ("f_{:03d}.png", "f_%03d.png"),
        "%3d": ("f_{:03d}.png", "f_%3d.png"),
        "%d": ("f_{:03d}.png", "f_%d.png"),
        "upper": ("F_{}.PNG", "F_%d.PNG"),
        "percent": ("a%_{}.png", "a%%_%d.png")}[form]
    for i, f in enumerate(frames):
        cv2.imwrite(str(tmp_path / name.format(i)), f)
    path = str(tmp_path / pattern)
    if form == "%d":
        assert cv2_frames(path) == []
        with pytest.raises(OSError, match="cannot open video source"):
            VideoReader(path)
        return
    assert same_as_cv2(path) == 3


def _png(img: np.ndarray, color: int, depth: int = 8, chunks=()) -> bytes:
    """PNG bytes of samples (H, W, channels) with filter type 0."""
    h, w = img.shape[:2]
    if depth == 16:
        rows = img.astype(">u2").reshape(h, -1).view(np.uint8)
    elif depth < 8:
        bits = ((img.reshape(h, w)[..., None] >> np.arange(
            depth - 1, -1, -1)) & 1).astype(np.uint8).reshape(h, -1)
        rows = np.packbits(bits, axis=1)
    else:
        rows = img.reshape(h, -1).astype(np.uint8)
    raw = b"".join(b"\0" + r.tobytes() for r in rows)
    return _png_file(w, h, depth, color, raw, chunks)


PNG_KINDS = ["gray", "rgb", "rgba", "gray_alpha", "palette",
             "palette_trns", "rgb_trns", "gray1", "gray2", "gray4",
             "gray16", "gray_alpha16", "gamma", "odd_1x1"]


@pytest.mark.parametrize("kind", PNG_KINDS)
def test_single_png_matches_cv2(tmp_path, kind):
    """Every 8-bit-and-below colour type (alpha dropped, palette and tRNS,
    gray below 8 bits scaled), a gAMA chunk (no effect), and 16-bit gray
    through min((v + 128) >> 8, 255)."""
    rng = np.random.default_rng(PNG_KINDS.index(kind))
    h, w = (1, 1) if kind == "odd_1x1" else (23, 37)
    u8 = lambda c: rng.integers(0, 256, (h, w, c), np.uint8)   # noqa: E731
    chunks = ()
    if kind in ("gray", "odd_1x1"):
        blob = _png(u8(1), 0)
    elif kind in ("rgb", "gamma"):
        if kind == "gamma":
            chunks = ((b"gAMA", struct.pack(">I", 45455)),)
        blob = _png(u8(3), 2, chunks=chunks)
    elif kind == "rgba":
        blob = _png(u8(4), 6)
    elif kind == "gray_alpha":
        blob = _png(u8(2), 4)
    elif kind.startswith("palette"):
        pal = rng.integers(0, 256, (200, 3), np.uint8).tobytes()
        chunks = ((b"PLTE", pal),)
        if kind.endswith("trns"):
            chunks += ((b"tRNS", bytes(range(0, 250, 7))),)
        blob = _png(rng.integers(0, 220, (h, w, 1)), 3, chunks=chunks)
    elif kind == "rgb_trns":
        img = u8(3)
        img[::3, ::2] = (10, 20, 30)
        blob = _png(img, 2, chunks=((b"tRNS", struct.pack(">HHH", 10, 20,
                                                            30)),))
    elif kind.startswith("gray") and kind[4:].isdigit() and \
            int(kind[4:]) < 8:
        depth = int(kind[4:])
        blob = _png(rng.integers(0, 1 << depth, (h, w, 1)), 0, depth)
    else:
        ch = 1 if kind == "gray16" else 2
        blob = _png(rng.integers(0, 65536, (h, w, ch)), 0 if ch == 1 else 4,
                    16)
    assert same_as_cv2(_write(tmp_path / "x.png", blob)) == 1


@pytest.mark.parametrize("kind", [k for k in BMP_KINDS
                                  if not k.startswith("16")
                                  and not k.endswith("_delta")])
def test_single_bmp_matches_cv2(tmp_path, kind):
    """Every BMP kind of the imread tests that FFmpeg's bmp decoder gives
    as cv2.imread does: palettes (OS/2, V5, short), 24 and 32 bits (masks,
    top-down), RLE4 and RLE8."""
    assert same_as_cv2(_write(tmp_path / "x.bmp", _bmp_case(kind))) == 1


@pytest.mark.parametrize("case", ["420", "422", "444", "gray", "progressive",
                                  "restart", "63x47", "17x33", "1x1",
                                  "exif6", "exif8", "itu601", "no_ext",
                                  "png_name"])
def test_single_jpeg_matches_cv2(tmp_path, case):
    """A JPEG file is one frame of FFmpeg's mjpeg decoder (not libjpeg's
    imread pixels): every sampling, progressive, restarts, odd sizes; its
    EXIF orientation is not applied; a CS=ITU601 comment takes limited
    range; it is read by content (no extension, a .png name)."""
    w, h = 64, 48
    if case[0].isdigit() and "x" in case:
        w, h = (int(v) for v in case.split("x"))
    img = scene(w, h, 5, 1)[0]
    params = {"420": (S, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420),
              "422": (S, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422),
              "444": (S, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444),
              "progressive": (cv2.IMWRITE_JPEG_PROGRESSIVE, 1),
              "restart": (cv2.IMWRITE_JPEG_RST_INTERVAL, 2)}.get(case, ())
    data = jpeg(cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) if case == "gray"
                else img, Q, 90, *params)
    if case.startswith("exif"):
        data = with_exif(data, int(case[4:]))
    if case == "itu601":
        com = b"CS=ITU601\0"
        data = data[:2] + b"\xff\xfe" + struct.pack(">H", len(com) + 2) + \
            com + data[2:]
    name = {"no_ext": "frame", "png_name": "x.png"}.get(case, "x.jpg")
    assert same_as_cv2(_write(tmp_path / name, data)) == 1


def test_pattern_of_jpegs_keeps_itu601(tmp_path):
    """One decoder reads a pattern's files: a CS=ITU601 comment in the
    second file keeps limited range for the third."""
    frames = [jpeg(f, Q, 85) for f in scene(40, 30, 6, 3)]
    com = b"CS=ITU601\0"
    frames[1] = frames[1][:2] + b"\xff\xfe" + struct.pack(
        ">H", len(com) + 2) + com + frames[1][2:]
    for i, data in enumerate(frames):
        _write(tmp_path / f"j_{i}.jpg", data)
    assert same_as_cv2(str(tmp_path / "j_%d.jpg")) == 3


@pytest.mark.parametrize("kind", ["png", "jpg", "bmp", "mixed_gray"])
def test_pattern_of_each_codec_matches_cv2(tmp_path, kind):
    """Patterns of PNG, JPEG and BMP files (a gray file among colour ones
    at the same size)."""
    frames = scene(33, 21, 7, 4)
    ext = "png" if kind == "mixed_gray" else kind
    for i, f in enumerate(frames):
        if kind == "mixed_gray" and i == 2:
            f = cv2.cvtColor(f, cv2.COLOR_BGR2GRAY)
        cv2.imwrite(str(tmp_path / f"s_{i:02d}.{ext}"), f)
    assert same_as_cv2(str(tmp_path / f"s_%02d.{ext}")) == 4


@pytest.mark.parametrize("case", ["png_garbage", "jpeg_in_png", "first_bad",
                                  "avi_mjpeg", "avi_short_i420"])
def test_first_failed_read_ends_the_jax_reader(tmp_path, case):
    """A packet the decoder rejects is where cv2's read first returns
    False: the JAX reader, the port's ImageSeriesReader and VideoReader's
    iteration all stop there."""
    frames = scene(32, 24, 8, 3)
    if case.startswith("avi"):
        if case == "avi_mjpeg":
            data = [jpeg(f) for f in frames]
            data[1] = b"\xff\xd8garbage" * 10
            blob = mux_avi(data, 32, 24)
        else:
            n = 32 * 24 * 3 // 2
            data = [f.tobytes()[:n] for f in frames]
            data[1] = data[1][:-1]
            blob = mux_avi(data, 32, 24, fourcc=b"I420")
        path = _write(tmp_path / "clip.avi", blob)
        stop = 1
    else:
        for i, f in enumerate(frames):
            cv2.imwrite(str(tmp_path / f"f_{i}.png"), f)
        bad = 0 if case == "first_bad" else 1
        _write(tmp_path / f"f_{bad}.png",
               jpeg(frames[bad]) if case == "jpeg_in_png" else b"garbage")
        path = str(tmp_path / "f_%d.png")
        stop = bad
    assert same_as_cv2(path) == stop
    cap, reads = cv2.VideoCapture(path), []
    for _ in range(4):
        reads.append(cap.read()[0])
    cap.release()
    assert reads.index(False) == stop
    with VideoReader(path) as reader:
        assert len(list(reader)) == stop
    got = list(ImageSeriesReader(path).iter_named())
    want = list(JaxReader(path).iter_named())
    assert len(got) == len(want) == stop
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _refused(tmp_path, kind: str) -> str:
    rng = np.random.default_rng(3)
    img = scene(24, 16, 2, 1)[0]
    if kind == "png16":
        cv2.imwrite(str(tmp_path / "c16.png"),
                    rng.integers(0, 65536, (16, 24, 3)).astype(np.uint16))
        return str(tmp_path / "c16.png")
    if kind == "adam7":
        raw = b"".join(b"\0" + img[y0::dy, x0::dx][r].tobytes()
                       for x0, y0, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8),
                                              (0, 4, 4, 8), (2, 0, 4, 4),
                                              (0, 2, 2, 4), (1, 0, 2, 2),
                                              (0, 1, 1, 2))
                       for r in range(img[y0::dy, x0::dx].shape[0]))
        return _write(tmp_path / "i.png", _png_file(24, 16, 8, 2, raw,
                                                    interlace=1))
    if kind.startswith("bmp"):
        name = {"bmp16": "16_565bf", "bmp_delta": "rle8_delta"}[kind]
        return _write(tmp_path / "x.bmp", _bmp_case(name))
    if kind in ("tiff", "webp"):
        cv2.imwrite(str(tmp_path / f"x.{kind}"), img)
        return str(tmp_path / f"x.{kind}")
    if kind == "tiff_pattern":
        cv2.imwrite(str(tmp_path / "t_0.tif"), img)
        return str(tmp_path / "t_%d.tif")
    if kind == "cap_images":
        cv2.imwrite(str(tmp_path / "d_0.png"), img)
        os.rename(tmp_path / "d_0.png", tmp_path / "d_0.dat")
        return str(tmp_path / "d_%d.dat")
    if kind == "sizes":
        cv2.imwrite(str(tmp_path / "z_0.png"), img)
        cv2.imwrite(str(tmp_path / "z_1.png"), scene(20, 12, 2, 1)[0])
        return str(tmp_path / "z_%d.png")
    # two JPEGs under a PNG name: FFmpeg's image2 probes the first bytes,
    # which hold only the first image here, and decodes that one
    big = scene(128, 96, 2, 1)[0]
    return _write(tmp_path / "two.png", jpeg(big) + jpeg(big[::-1]))


@pytest.mark.parametrize("kind,match", [
    ("png16", "16-bit colour PNG"), ("adam7", "Adam7"),
    ("bmp16", "16-bit BMP"), ("bmp_delta", "delta"), ("tiff", "TIFF"),
    ("webp", "WebP"), ("tiff_pattern", "TIFF"), ("cap_images", "CAP_IMAGES"),
    ("sizes", "differ in size"), ("raw_mjpeg", "raw Motion JPEG")])
def test_image_refusals_name_what_they_refuse(tmp_path, kind, match):
    """What cv2 opens and the port does not reproduce raises
    UnsupportedVideo naming it, at open or at the frame."""
    path = _refused(tmp_path, kind)
    assert cv2_frames(path)
    with pytest.raises(UnsupportedVideo, match=match):
        with VideoReader(path) as reader:
            list(reader)


@pytest.mark.parametrize("name,fourcc", [("clip%d.avi", "MJPG"),
                                         ("take_%03d.mkv", "FFV1"),
                                         ("x%d.mp4", "MPNG")])
@pytest.mark.parametrize("numbered", [False, True])
def test_literal_field_in_a_video_name_opens_the_file(tmp_path, name,
                                                      fourcc, numbered):
    """A file whose name holds a printf field and whose extension is not
    an image one is opened by content, as FFmpeg's image2 probe gives it
    no score; a file at the field's number 0 beside it changes nothing."""
    ext = name.rsplit(".", 1)[1]
    frames = scene(32, 24, 5, 3)
    write_cv2_clip(str(tmp_path / f"tmp.{ext}"), frames, fourcc)
    path = str(tmp_path / name)
    os.rename(tmp_path / f"tmp.{ext}", path)
    if numbered:
        _write(tmp_path / name.replace("%d", "0").replace("%03d", "000"),
               open(path, "rb").read())
    assert same_as_cv2(path) == 3


def test_png_frame_lets_errors_other_than_decode_errors_through(
        tmp_path, monkeypatch):
    """Only what the PNG decoder rejects is a rejected packet; any other
    error inside it propagates instead of ending the stream early."""
    from fealess_tpu_torch.io import png
    frames = scene(24, 16, 2, 3)
    for i, f in enumerate(frames):
        cv2.imwrite(str(tmp_path / f"p_{i}.png"), f)
    path = str(tmp_path / "p_%d.png")
    assert len(jax_reads(path)) == len(frames)

    def broken(*args):
        raise TypeError("a fault in the decoder")
    monkeypatch.setattr(png, "_decode_chunks", broken)
    with pytest.raises(TypeError, match="a fault in the decoder"):
        jax_reads(path)


def _acq(fn, source, out, depth, **extra) -> int:
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(source, out, depth_dir=depth, save_clouds=True,
                  target_wh=(64, 48), **extra)


@pytest.mark.parametrize("source", ["one_png", "pattern", "one_jpg",
                                    "pattern_jpg"])
def test_acquire_series_from_image_and_pattern_equals_jax(tmp_path, source):
    """acquire_series from one PNG (or JPEG) file and from a %03d pattern,
    with a depth directory: the frames are nameless, so depth pairs by
    position, and gray/, depth/ and cloud/ equal the JAX tool's."""
    from tests.test_torch_video import _outputs_equal
    frames = scene(64, 48, 9, 3)
    seq = tmp_path / "seq"
    seq.mkdir()
    ext = "jpg" if source.endswith("jpg") else "png"
    for i, f in enumerate(frames):
        cv2.imwrite(str(seq / f"f_{i:03d}.{ext}"), f)
    dep = tmp_path / "depth"
    dep.mkdir()
    rng = np.random.default_rng(1)
    for stem in (0, 1, 2, 10):
        d = rng.integers(300, 1200, (48, 64)).astype(np.uint16)
        d[:4] = 0
        cv2.imwrite(str(dep / f"{stem}.png"), d)
    path = str(seq / (f"f_000.{ext}" if source.startswith("one")
                      else f"f_%03d.{ext}"))
    n = 1 if source.startswith("one") else 3
    outs = {}
    for name, fn, extra in (("jax", jax_acquire.acquire_series, {}),
                            ("port", acquire.acquire_series,
                             {"device": "cpu"})):
        outs[name] = str(tmp_path / name)
        assert _acq(fn, path, outs[name], str(dep), **extra) == n
    _outputs_equal(outs["port"], outs["jax"])
    assert sorted(os.listdir(os.path.join(outs["port"], "depth"))) == \
        [f"{i}.png" for i in range(n)]
