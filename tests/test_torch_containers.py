"""MP4, Matroska, raw planar YUV and PNG video through the port's
``io/video.VideoReader`` (``io/isobmff``, ``io/matroska``,
``io/rawvideo``, ``io/image2.png_frame``) against ``cv2.VideoCapture``:
clips from ``cv2.VideoWriter`` (fourcc 0, I420, IYUV, YV12, MPNG, FFV1,
MJPG in AVI, MP4 and Matroska) and hand-muxed files that reach what the
writer does not write (odd raw sizes; moov first, co64, chunk runs, edit
lists; Matroska block groups, lacing and unknown sizes), each bit for bit
and in cv2's number; the codecs and layouts still refused, by name; every
fourcc ``cv2.VideoWriter`` takes, in each container it writes, read to
cv2's frames or refused as a codec of the decoding queue (``QUEUED``, the
line of ROADMAP.md that names it); MP4 edit lists around the B-picture
delay; and ``ImageSeriesReader`` on these sources equal to the JAX
reader."""

import os
import struct

import cv2
import numpy as np
import pytest

from fealess_tpu.io.series import ImageSeriesReader as JaxReader
from fealess_tpu_torch.io import rawvideo
from fealess_tpu_torch.io.avi import AviFile
from fealess_tpu_torch.io.series import ImageSeriesReader
from fealess_tpu_torch.io.video import (QUEUED_CONTAINERS, QUEUED_FOURCCS,
                                        UnsupportedVideo,
                                        VideoReader)
from tests.make_torch_video import (cv2_frames, jpeg, mux_avi, scene,
                                    set_vol_bit, set_vp9_color_space,
                                    write_cv2_clip, yuv420p)
from tests.test_torch_image2 import same_as_cv2


def _write(tmp_path, data: bytes, name: str) -> str:
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


# ---- raw planar YUV ----

@pytest.mark.parametrize("ext", ["avi", "mkv"])
@pytest.mark.parametrize("fourcc", ["0", "I420", "IYUV", "YV12"])
@pytest.mark.parametrize("w,h", [(64, 48), (18, 34), (17, 33)])
def test_raw_yuv420p_from_cv2_writer_bitwise(tmp_path, ext, fourcc, w, h):
    """cv2.VideoWriter's raw fourccs (it writes yuv420p, at even sizes
    only: 17x33 is written as 16x32): limited range through swscale, not
    the frames written."""
    path = str(tmp_path / f"clip.{ext}")
    write_cv2_clip(path, scene(w, h, 1, 3), fourcc)
    assert same_as_cv2(path) == 3


@pytest.mark.parametrize("fourcc", [b"I420", b"IYUV", b"YV12"])
@pytest.mark.parametrize("w,h", [(17, 33), (16, 33), (17, 32), (3, 3),
                                 (1, 1), (2, 1), (1, 2), (65, 47),
                                 (640, 481)])
def test_raw_yuv420p_odd_sizes_bitwise(tmp_path, fourcc, w, h):
    """Hand-muxed raw frames of random planes at odd sizes: chroma is
    ceil(W/2) x ceil(H/2) with no padding, and each of swscale's paths
    (unscaled, full chroma, the odd-height rows) holds."""
    rng = np.random.default_rng(w * 1000 + h)
    n = rawvideo.frame_size(w, h)
    frames = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
              for _ in range(2)]
    path = _write(tmp_path, mux_avi(frames, w, h, fourcc=fourcc), "raw.avi")
    assert same_as_cv2(path) == 2


def test_raw_packet_sizes(tmp_path):
    """A packet longer than the frame is read (the rest ignored); a
    shorter one is rejected, where cv2's read returns False."""
    w, h = 16, 8
    n = rawvideo.frame_size(w, h)
    frames = [yuv420p(f) for f in scene(w, h, 2, 3)]
    path = _write(tmp_path, mux_avi([frames[0] + b"\7" * 9, frames[1],
                                     frames[2][:n - 1]], w, h,
                                    fourcc=b"I420"), "raw.avi")
    assert same_as_cv2(path) == 2
    with AviFile(path) as avi:
        assert len(list(avi.frames())) == 3
    with VideoReader(path) as reader:
        assert len(list(reader)) == 2


def test_yuv420p_planes_with_strides():
    """The planar entry takes strided planes (a view of a wider array)."""
    rng = np.random.default_rng(4)
    big = rng.integers(0, 256, (40, 60), np.uint8)
    y, u, v = big[:11, :21], big[20:26, :11], big[30:36, 20:31]
    got = rawvideo.yuv420p_to_bgr(y, u, v)
    want = rawvideo.yuv420p_to_bgr(y.copy(), u.copy(), v.copy())
    np.testing.assert_array_equal(got, want)
    frame = rawvideo.decode_raw(
        y.tobytes() + u.tobytes() + v.tobytes(), 21, 11, "yuv420p")
    np.testing.assert_array_equal(frame, want)


# ---- PNG video, Huffyuv, FFV1 and Motion JPEG in MP4 and Matroska ----

@pytest.mark.parametrize("ext", ["avi", "mp4", "mkv"])
@pytest.mark.parametrize("w,h", [(64, 48), (18, 34), (2, 2)])
def test_png_video_bitwise(tmp_path, ext, w, h):
    """MPNG (8-bit RGB PNGs) in each container: the frames written."""
    path = str(tmp_path / f"clip.{ext}")
    frames = scene(w, h, 3, 3)
    write_cv2_clip(path, frames, "MPNG")
    assert same_as_cv2(path) == 3
    for got, want in zip(VideoReader(path), frames):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ext", ["avi", "mkv"])
@pytest.mark.parametrize("w,h,kind", [(64, 48, "scene"), (18, 34, "scene"),
                                      (2, 2, "noise"), (640, 480, "noise"),
                                      (34, 18, "noise")])
def test_huffyuv_bitwise(tmp_path, ext, w, h, kind):
    """HFYU from cv2.VideoWriter (version 2, RGB24, left prediction,
    decorrelated; codes up to the longest a noise frame needs): the frames
    written."""
    path = str(tmp_path / f"clip.{ext}")
    rng = np.random.default_rng(w + h)
    frames = (scene(w, h, 13, 2) if kind == "scene" else
              [rng.integers(0, 256, (h, w, 3), np.uint8) for _ in range(2)])
    write_cv2_clip(path, frames, "HFYU")
    assert same_as_cv2(path) == 2
    for got, want in zip(VideoReader(path), frames):
        np.testing.assert_array_equal(got, want)


def _len_table(runs) -> bytes:
    """Huffyuv's run-length coded code lengths: (repeat, length) runs,
    each as 3 bits of repeat and 5 of length, or 0 and an 8-bit repeat."""
    bits = "".join((f"{0:03b}{val:05b}{rep:08b}" if rep > 7 else
                    f"{rep:03b}{val:05b}") for rep, val in runs)
    bits += "0" * (-len(bits) % 8)
    return bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))


@pytest.mark.parametrize("case", ["all_length_1", "all_length_7", "zeros",
                                  "ffv1_crc"])
def test_corrupt_extradata_does_not_open_as_in_cv2(tmp_path, case):
    """Code lengths that claim more codes than they allow (all 256 at 1
    bit, or at 7 bits, which pass the parity test), tables that never end,
    and FFV1 extradata failing its CRC: FFmpeg's decoder does not open,
    so cv2 does not open the file; the decoder raises DecodeError and
    VideoReader the JAX reader's OSError."""
    from fealess_tpu_torch.io.huffyuv import HuffyuvDecoder
    from fealess_tpu_torch.io.png import DecodeError
    path = str(tmp_path / "clip.avi")
    write_cv2_clip(path, scene(16, 8, 2, 1),
                   "FFV1" if case == "ffv1_crc" else "HFYU")
    with AviFile(path) as avi:
        extradata = avi.stream.extradata
    if case == "ffv1_crc":
        bad = extradata[:5] + bytes([extradata[5] ^ 0x10]) + extradata[6:]
    else:
        runs = {"all_length_1": [(255, 1), (1, 1)],
                "all_length_7": [(255, 7), (1, 7)], "zeros": []}[case]
        body = _len_table(runs) * 3
        bad = extradata[:4] + body + bytes(len(extradata) - 4 - len(body))
        with pytest.raises(DecodeError, match="corrupt Huffyuv tables"):
            HuffyuvDecoder(bad, 16, 8)
    assert len(bad) == len(extradata)
    blob = open(path, "rb").read()
    at = blob.index(extradata)
    path = _write(tmp_path, blob[:at] + bad + blob[at + len(bad):], "bad.avi")
    assert not cv2.VideoCapture(path).isOpened()
    with pytest.raises(OSError, match="cannot open video source"):
        VideoReader(path)


def test_chip_smoke_huffyuv_frames_are_ffmpegs(tmp_path):
    """chip_smoke.py times Huffyuv on 640x480 frames it encodes with the
    committed clip's tables: its encoder gives FFmpeg's packets byte for
    byte on the committed clip, and its 640x480 clip decodes to the frames
    given, in cv2 and in the port."""
    import chip_smoke
    clip = os.path.join(os.path.dirname(__file__), "data", "torch_video",
                        "hfyu.avi")
    with AviFile(clip) as avi:
        tables, packets = avi.stream.extradata, list(avi.frames())
    frames = list(VideoReader(clip))
    assert [chip_smoke.huffyuv_bytes(f, tables) for f in frames] == packets
    rng = np.random.default_rng(5)
    big = [np.tile(scene(64, 48, 13, 1)[0], (10, 10, 1)),
           rng.integers(0, 256, (480, 640, 3), np.uint8)]
    path = _write(tmp_path, chip_smoke.avi_bytes(
        [chip_smoke.huffyuv_bytes(f, tables) for f in big], 640, 480,
        b"HFYU", tables), "hfyu640.avi")
    assert same_as_cv2(path) == 2
    for got, want in zip(VideoReader(path), big):
        np.testing.assert_array_equal(got, want)


def test_huffyuv_streams_it_does_not_read_are_named(tmp_path):
    """Huffyuv other than cv2.VideoWriter's (here its extradata with
    median prediction, or version 3): UnsupportedImage naming it, as
    UnsupportedVideo from the reader."""
    from fealess_tpu_torch.io.huffyuv import HuffyuvDecoder
    from fealess_tpu_torch.io.jpeg import UnsupportedImage
    path = str(tmp_path / "clip.avi")
    write_cv2_clip(path, scene(16, 8, 1, 1), "HFYU")
    with AviFile(path) as avi:
        extradata = avi.stream.extradata
    for patched in (bytes([0x42]) + extradata[1:],
                    extradata[:3] + b"\1" + extradata[4:]):
        with pytest.raises(UnsupportedImage, match="Huffyuv"):
            HuffyuvDecoder(patched, 16, 8)
    blob = open(path, "rb").read()
    at = blob.index(extradata)
    bad = _write(tmp_path, blob[:at] + bytes([0x42]) + blob[at + 1:],
                 "median.avi")
    with pytest.raises(UnsupportedVideo, match="Huffyuv"):
        list(VideoReader(bad))


@pytest.mark.parametrize("fourcc", [b"MPNG", b"PNG1"])
@pytest.mark.parametrize("w,h", [(17, 33), (1, 1)])
def test_png_video_odd_sizes_and_kinds(tmp_path, fourcc, w, h):
    """Hand-muxed PNG video at odd sizes (cv2.VideoWriter writes even ones
    only), with a gray and an RGBA frame among the RGB ones."""
    frames = scene(w, h, 12, 3)
    frames[1] = cv2.cvtColor(frames[1], cv2.COLOR_BGR2GRAY)
    frames[2] = cv2.cvtColor(frames[2], cv2.COLOR_BGR2BGRA)
    pngs = [cv2.imencode(".png", f)[1].tobytes() for f in frames]
    path = _write(tmp_path, mux_avi(pngs, w, h, fourcc=fourcc), "png.avi")
    assert same_as_cv2(path) == 3


@pytest.mark.parametrize("ext", ["mp4", "mkv"])
@pytest.mark.parametrize("fourcc", ["FFV1", "MJPG"])
@pytest.mark.parametrize("w,h,n", [(64, 48, 3), (17, 33, 2), (34, 18, 14)])
def test_mp4_and_matroska_bitwise(tmp_path, ext, fourcc, w, h, n):
    """FFV1 (extradata from glbl / CodecPrivate; past its 12-frame group)
    and Motion JPEG (MP4's mp4v with object type 0x6C) from
    cv2.VideoWriter."""
    path = str(tmp_path / f"clip.{ext}")
    write_cv2_clip(path, scene(w, h, 4, n), fourcc)
    assert same_as_cv2(path) == n


def _box(kind: bytes, body: bytes, large: bool = False) -> bytes:
    if large:
        return struct.pack(">I4sQ", 1, kind, 16 + len(body)) + body
    return struct.pack(">I4s", 8 + len(body), kind) + body


def _descr(tag: int, body: bytes) -> bytes:
    n = len(body)
    return bytes([tag, 0x80 | (n >> 21) & 0x7F, 0x80 | (n >> 14) & 0x7F,
                  0x80 | (n >> 7) & 0x7F, n & 0x7F]) + body


def mux_mp4(samples, w: int, h: int, fmt: bytes = b"mp4v",
            object_type: int = 0x6C, glbl: bytes = b"",
            moov_first: bool = False, co64: bool = False,
            per_chunk: int = 1, edits="full", mdat_to_end: bool = False,
            large: bool = False) -> bytes:
    """An MP4 of one video track at 10 frames a second (media timescale
    10, movie timescale 1000) holding ``samples``; ``edits``: (duration
    in ms, media time) of each elst entry, "full" for one over every
    frame (what cv2.VideoWriter writes), or None for no edts."""
    n = len(samples)
    if edits == "full":
        edits = ((100 * n, 0),)
    chunks = [samples[i:i + per_chunk] for i in range(0, n, per_chunk)]
    ftyp = _box(b"ftyp", b"isom\0\0\2\0isomiso2mp41")

    def moov(offsets):
        mvhd = struct.pack(">IIIII", 0, 0, 0, 1000, 100 * n) + \
            struct.pack(">IH10x", 0x10000, 0x100) + \
            struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                        0x40000000) + bytes(24) + struct.pack(">I", 2)
        tkhd = struct.pack(">IIIIII8xHHHH", 3, 0, 0, 1, 0, 100 * n, 0, 0,
                           0, 0) + struct.pack(
            ">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000) + \
            struct.pack(">II", w << 16, h << 16)
        mdhd = struct.pack(">IIIIIHH", 0, 0, 0, 10, n, 0x55C4, 0)
        hdlr = struct.pack(">II4s12x", 0, 0, b"vide") + b"VideoHandler\0"
        entry = struct.pack(">6xHHH12xHHIIIH32sHh", 1, 0, 0, w, h, 0x480000,
                            0x480000, 0, 1, b"", 0x18, -1)
        if fmt == b"mp4v":
            dec = bytes([object_type, 0x11, 0, 0, 0]) + bytes(8)
            es = struct.pack(">HB", 1, 0) + _descr(4, dec) + _descr(6, b"\2")
            entry += _box(b"esds", b"\0\0\0\0" + _descr(3, es))
        if glbl:
            entry += _box(b"glbl", glbl)
        stsd = struct.pack(">II", 0, 1) + _box(fmt, entry)
        stts = struct.pack(">IIII", 0, 1, n, 1)
        runs = [(1, per_chunk)]
        if n % per_chunk:
            runs.append((len(chunks), n % per_chunk))
        stsc = struct.pack(">II", 0, len(runs)) + b"".join(
            struct.pack(">III", first, count, 1) for first, count in runs)
        stsz = struct.pack(">III", 0, 0, n) + b"".join(
            struct.pack(">I", len(s)) for s in samples)
        if co64:
            co = _box(b"co64", struct.pack(">II", 0, len(offsets)) + b"".join(
                struct.pack(">Q", o) for o in offsets))
        else:
            co = _box(b"stco", struct.pack(">II", 0, len(offsets)) + b"".join(
                struct.pack(">I", o) for o in offsets))
        stbl = _box(b"stbl", _box(b"stsd", stsd) + _box(b"stts", stts)
                    + _box(b"stsc", stsc) + _box(b"stsz", stsz) + co)
        dinf = _box(b"dinf", _box(b"dref", struct.pack(">II", 0, 1)
                                  + _box(b"url ", b"\0\0\0\1")))
        minf = _box(b"minf", _box(b"vmhd", struct.pack(">IQ", 1, 0)) + dinf
                    + stbl)
        mdia = _box(b"mdia", _box(b"mdhd", mdhd) + _box(b"hdlr", hdlr) + minf)
        trak = _box(b"tkhd", tkhd)
        if edits is not None:
            elst = struct.pack(">II", 0, len(edits)) + b"".join(
                struct.pack(">IiI", d, m, 0x10000) for d, m in edits)
            trak += _box(b"edts", _box(b"elst", elst))
        return _box(b"moov", _box(b"mvhd", mvhd) + _box(b"trak", trak + mdia))

    payload = b"".join(samples)
    head = 16 if large else 8
    if moov_first:
        size = len(moov([0] * len(chunks)))
        start = len(ftyp) + size + head
    else:
        start = len(ftyp) + head
    offsets, at = [], start
    for c in chunks:
        offsets.append(at)
        at += sum(len(s) for s in c)
    mdat = _box(b"mdat", payload, large)
    if mdat_to_end:
        mdat = struct.pack(">I4s", 0, b"mdat") + payload
    if moov_first:
        return ftyp + moov(offsets) + mdat
    assert not mdat_to_end
    return ftyp + mdat + moov(offsets)


def _ffv1_stream(w: int, h: int, n: int, tmp_path):
    """FFV1 packets and extradata from a cv2.VideoWriter AVI."""
    path = str(tmp_path / "ffv1.avi")
    write_cv2_clip(path, scene(w, h, 6, n), "FFV1")
    with AviFile(path) as avi:
        return list(avi.frames()), avi.stream.extradata


@pytest.mark.parametrize("layout", [
    {}, {"moov_first": True}, {"co64": True}, {"per_chunk": 2},
    {"per_chunk": 3, "co64": True}, {"edits": None},
    {"edits": ((500, -1), (500, 0))},
    {"moov_first": True, "mdat_to_end": True}, {"large": True},
    {"fmt": b"jpeg"}, {"fmt": b"png "}, {"object_type": 0x6D},
    {"fmt": b"FFV1"}])
def test_mp4_layouts(tmp_path, layout):
    """Hand-muxed MP4s: moov before mdat, 64-bit offsets and box sizes,
    samples grouped in chunks (stsc runs), an empty edit before a full one,
    mdat to the end of the file, and the sample entries jpeg, png and
    FFV1 (glbl) and mp4v with PNG's object type."""
    w, h, n = 40, 30, 5
    layout = dict(layout)
    png = layout.get("fmt") == b"png " or layout.get("object_type") == 0x6D
    frames = scene(w, h, 7, n)
    if layout.get("fmt") == b"FFV1":
        samples, layout["glbl"] = _ffv1_stream(w, h, n, tmp_path)
    elif png:
        samples = [cv2.imencode(".png", f)[1].tobytes() for f in frames]
    else:
        samples = [jpeg(f) for f in frames]
    path = _write(tmp_path, mux_mp4(samples, w, h, **layout), "clip.mp4")
    assert same_as_cv2(path) == n


@pytest.mark.parametrize("edits,match", [
    (((200, 0),), "edit list"), (((500, 1),), "edit list"),
    (((200, 0), (200, 3)), "edit list"), (((0, 0),), "edit list")])
def test_mp4_edit_lists_that_drop_frames_are_refused(tmp_path, edits,
                                                     match):
    """An edit that starts past media time 0, ends before the last frame
    (a zero duration too) or comes with another: FFmpeg drops frames
    outside it (cv2 reads fewer than the samples), and the port refuses it
    by name."""
    samples = [jpeg(f) for f in scene(40, 30, 8, 5)]
    path = _write(tmp_path, mux_mp4(samples, 40, 30, edits=edits),
                  "clip.mp4")
    assert len(cv2_frames(path)) < 5
    with pytest.raises(UnsupportedVideo, match=match):
        VideoReader(path)


def _mp4_with_edits(data: bytes, edits) -> bytes:
    """``data`` (an MP4 whose moov follows mdat, as cv2.VideoWriter writes
    it) with its elst box's entries replaced by ``edits`` ((duration in
    movie units, media time) each); the parent boxes' sizes follow."""
    at = data.index(b"elst") - 4
    size = struct.unpack_from(">I", data, at)[0]
    body = struct.pack(">II", 0, len(edits)) + b"".join(
        struct.pack(">IiI", d, m, 0x10000) for d, m in edits)
    new = _box(b"elst", body)
    out = bytearray(data[:at] + new + data[at + size:])
    for kind in (b"edts", b"trak", b"moov"):
        k = out.index(kind) - 4
        out[k:k + 4] = struct.pack(">I", struct.unpack_from(">I", out, k)[0]
                                   + len(new) - size)
    return bytes(out)


@pytest.mark.parametrize("edits", [
    ((1600, 1024),), ((1700, 1024),), ((100, -1), (1600, 1024)),
    ((1600, 0),), ((1600, 2048),), ((1000, 1024),),
    ((800, 1024), (800, 9216))], ids=[
        "delay", "delay_longer", "empty_then_delay", "media_time_0",
        "media_time_2048", "short", "two_edits"])
def test_mp4_edit_lists_with_b_picture_delay(tmp_path, edits):
    """cv2.VideoWriter's MP4 with B pictures (16 frames of MPEG-2) has one
    edit from media time 1024, its smallest composition time (ctts), at a
    timescale of 10240: FFmpeg drops no frame there, and the port reads
    every frame as cv2 does.  Hand-edited elst boxes that start at another
    time, end before the last frame is shown or add an edit: the port
    reads cv2's frames or refuses the file by name."""
    src = os.path.join(os.path.dirname(__file__), "data", "torch_mpeg2",
                       "mpeg2_pan.mp4")
    with open(src, "rb") as f:
        data = f.read()
    assert struct.unpack_from(">IiI", data, data.index(b"elst") + 12) == (
        1600, 1024, 0x10000)
    path = _write(tmp_path, _mp4_with_edits(data, edits), "clip.mp4")
    want = cv2_frames(path)
    try:
        got = list(VideoReader(path))
    except UnsupportedVideo as e:
        assert "edit list that drops frames" in str(e)
        assert edits[-1] != (1600, 1024)
        return
    assert edits[-1][1] == 1024 and len(got) == len(want) == 16
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# the fourccs cv2.VideoWriter takes, each written in AVI, MP4, MOV and
# Matroska where the writer opens
EVERY_FOURCC = ("MJPG", "FFV1", "I420", "MPNG", "HFYU", "mp4v", "XVID",
                "DIVX", "VP80", "VP90", "MPG2", "DIV3", "MP42", "WMV1",
                "WMV2", "FLV1", "H263")
# (fourcc, extension) pairs past EVERY_FOURCC's matrix that the writer
# writes and cv2 reads (ROADMAP item 13): the readers that need no new
# decoder, the containers and the codecs queued
WRITER_PAIRS = (
    ("jpeg", "avi"), ("LJPG", "avi"), ("GEOX", "avi"), ("xd5b", "mov"),
    ("mp2v", "mov"), ("Y800", "avi"), ("Y800", "mkv"), ("Y8  ", "avi"),
    ("GREY", "avi"), ("GREY", "mkv"), ("NV12", "avi"), ("NV12", "mkv"),
    ("RGBA", "avi"), ("RGBA", "mkv"), ("RGBA", "mov"), ("I420", "y4m"),
    ("Y800", "y4m"), ("YUY2", "y4m"), ("MPG2", "m2v"), ("MJPG", "mjpeg"),
    ("MPG2", "mpg"), ("mp4v", "mpg"), ("MPG2", "ts"), ("mp4v", "ts"),
    ("MPG2", "m2ts"), ("mp4v", "m2ts"), ("MJPG", "ismv"), ("VP80", "ogv"),
    ("VP90", "flv"), ("MJPG", "asf"), ("FFV1", "nut"), ("MJPG", "nut"),
    ("FFVH", "avi"), ("FFVH", "mov"), ("FFVH", "mkv"), ("ULY0", "avi"),
    ("ULY0", "mov"), ("ULY0", "mkv"), ("magy", "avi"), ("magy", "mov"),
    ("magy", "mkv"), ("MJLS", "avi"), ("MJLS", "mov"), ("MJLS", "mkv"),
    ("ASV1", "avi"), ("ASV1", "mov"), ("ASV1", "mkv"), ("ASV2", "avi"),
    ("ASV2", "mov"), ("ASV2", "mkv"), ("tiff", "avi"), ("tiff", "mov"),
    ("tiff", "mkv"), ("SNOW", "avi"), ("SNOW", "mov"), ("SNOW", "mkv"),
    ("drac", "avi"), ("drac", "mov"), ("drac", "mkv"), ("drac", "drc"),
    ("MJ2C", "avi"), ("MJ2C", "mov"), ("MJ2C", "mkv"), ("MJ2C", "mp4"),
    ("RV10", "rm"), ("RV20", "rm"), ("FLV1", "swf"), ("mp4v", "3gp"),
    ("H263", "3gp"), ("U263", "avi"), ("h263", "mov"), ("s263", "3gp"),
    ("s263", "3g2"), ("s263", "avi"), ("s263", "mkv"), ("s263", "flv"),
    ("H263", "3g2"), ("MP43", "avi"), ("DIV4", "avi"), ("DIV5", "avi"),
    ("MPG3", "avi"), ("AP41", "avi"), ("COL1", "avi"), ("DIV2", "avi"),
    ("3IVD", "mov"))
# the fourccs of H.263, whose writer takes its five picture sizes only
H263_TAGS = ("H263", "U263", "h263", "s263")
# the containers item 13 (b) demuxes, each written with every fourcc of
# EVERY_FOURCC (the pairs WRITER_PAIRS holds left out)
DEMUXED_EXTENSIONS = ("mpg", "vob", "ts", "m2ts", "ismv", "ogv", "flv",
                      "asf", "wmv", "nut")
DEMUXED_PAIRS = tuple((f, e) for e in DEMUXED_EXTENSIONS for f in EVERY_FOURCC
                      if (f, e) not in WRITER_PAIRS)
# the codecs the port refuses by name and ROADMAP's decoding queue lists
QUEUED = tuple(QUEUED_FOURCCS)


def _queue_line(prefix: str):
    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "ROADMAP.md")) as f:
        line = next(ln for ln in f if ln.startswith(prefix))
    return [n.strip().rstrip(".") for n in line.split(":", 1)[1].split(";")]


def test_queued_is_roadmaps_decoding_queue():
    """QUEUED names the codecs of ROADMAP.md's decoding queue line, and
    MPEG-2 is not among them."""
    assert sorted(_queue_line("Decoding queue:")) == sorted(QUEUED)
    assert "MPEG-2" not in QUEUED


def test_queued_containers_are_roadmaps_demuxing_queue():
    """QUEUED_CONTAINERS names the containers of ROADMAP.md's demuxing
    queue line; the ones the port reads are not among them."""
    assert sorted(_queue_line("Demuxing queue:")) == sorted(QUEUED_CONTAINERS)
    assert not {"AVI", "Matroska", "YUV4MPEG2"} & set(QUEUED_CONTAINERS)


@pytest.mark.parametrize("fourcc,ext", [
    (f, e) for f in EVERY_FOURCC for e in ("avi", "mp4", "mov", "mkv")]
    + list(WRITER_PAIRS) + list(DEMUXED_PAIRS), ids=lambda v: v.strip())
def test_every_codec_cv2_writes_is_read_or_queued(tmp_path, fourcc, ext):
    """Four frames through cv2.VideoWriter (96x64; 128x96 for every H.263
    tag, whose picture sizes are fixed): the port reads them to cv2's
    frames, or
    refuses the file naming a codec of QUEUED or a container of
    QUEUED_CONTAINERS; where cv2 does not open what its writer wrote, the
    port raises OSError as the JAX reader does.  A codec or container cv2
    writes that is neither read nor queued fails here."""
    import cv2
    w, h = (128, 96) if fourcc in H263_TAGS else (96, 64)
    path = str(tmp_path / f"clip.{ext}")
    vw = cv2.VideoWriter(path, cv2.CAP_FFMPEG,
                         cv2.VideoWriter_fourcc(*fourcc), 10, (w, h))
    if not vw.isOpened():               # the writer takes no such file
        assert (fourcc, ext) not in WRITER_PAIRS
        assert ext not in ("asf", "wmv", "nut"), "ASF and NUT take all"
        return
    for f in scene(w, h, 3, 4):
        vw.write(f)
    vw.release()
    cap = cv2.VideoCapture(path)
    opened = cap.isOpened()
    cap.release()
    if not opened:
        with pytest.raises(OSError, match="cannot open video source"):
            VideoReader(path)
        return
    want = cv2_frames(path)
    try:
        got = list(VideoReader(path))
    except UnsupportedVideo as e:
        assert any(f"{name} " in str(e)
                   for name in QUEUED + QUEUED_CONTAINERS), str(e)
        return
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _ebml_id(eid: int) -> bytes:
    return eid.to_bytes((eid.bit_length() + 7) // 8, "big")


def _el(eid: int, body: bytes, unknown: bool = False) -> bytes:
    size = b"\x01" + (b"\xff" * 7 if unknown else len(body).to_bytes(7,
                                                                      "big"))
    return _ebml_id(eid) + size + body


def _uint(eid: int, v: int) -> bytes:
    return _el(eid, v.to_bytes(max(1, (v.bit_length() + 7) // 8), "big"))


def _vint(v: int, n: int) -> bytes:
    return ((1 << (7 * n)) | v).to_bytes(n, "big")


def mux_mkv(frames, w: int, h: int, codec_id: str = "V_MJPEG",
            private: bytes = b"", colour_space: bytes = b"",
            group: bool = False, lacing: str = "", per_cluster: int = 0,
            unknown_cluster: bool = False, unknown_segment: bool = False,
            track_type: int = 1) -> bytes:
    """A Matroska file of one video track holding ``frames``: in
    SimpleBlocks or BlockGroups, one frame a block or laced in pairs
    (``lacing``: "xiph", "ebml", "fixed"), ``per_cluster`` blocks a
    Cluster (0: one Cluster), Clusters and the Segment of unknown size;
    ``track_type`` 2 makes the track an audio one."""
    head = _el(0x1A45DFA3, _uint(0x4286, 1) + _uint(0x42F7, 1)
               + _uint(0x42F2, 4) + _uint(0x42F3, 8)
               + _el(0x4282, b"matroska") + _uint(0x4287, 4)
               + _uint(0x4285, 2))
    video = _uint(0xB0, w) + _uint(0xBA, h)
    if colour_space:
        video += _el(0x2EB524, colour_space)
    entry = (_uint(0xD7, 1) + _uint(0x73C5, 1) + _uint(0x83, track_type)
             + _el(0x86, codec_id.encode()) + _el(0xE0, video))
    if private:
        entry += _el(0x63A2, private)
    info = _el(0x1549A966, _uint(0x2AD7B1, 1000000) + _el(0x4D80, b"t"))
    tracks = _el(0x1654AE6B, _el(0xAE, entry))
    blocks = []
    step = 2 if lacing else 1
    for i in range(0, len(frames), step):
        part = frames[i:i + step]
        lace = {"": 0, "xiph": 1, "fixed": 2, "ebml": 3}[lacing]
        if len(part) == 1:
            lace = 0
        body = b"\x81" + struct.pack(">h", 100 * i) + bytes(
            [(0 if group else 0x80) | lace << 1])
        if lace:
            body += bytes([len(part) - 1])
            if lace == 1:
                s = len(part[0])
                body += b"\xff" * (s // 255) + bytes([s % 255])
            elif lace == 3:
                body += _vint(len(part[0]), 4)
        body += b"".join(part)
        blocks.append(_el(0xA0, _el(0xA1, body)) if group
                      else _el(0xA3, body))
    per = per_cluster or len(blocks)
    clusters = b"".join(
        _el(0x1F43B675, _uint(0xE7, 100 * k) + b"".join(
            blocks[k:k + per]), unknown_cluster)
        for k in range(0, len(blocks), per))
    return head + _el(0x18538067, info + tracks + clusters, unknown_segment)


@pytest.mark.parametrize("layout", [
    {}, {"group": True}, {"lacing": "xiph"}, {"lacing": "ebml"},
    {"lacing": "fixed"}, {"group": True, "lacing": "xiph"},
    {"per_cluster": 2}, {"per_cluster": 2, "unknown_cluster": True},
    {"unknown_segment": True},
    {"unknown_segment": True, "unknown_cluster": True, "per_cluster": 1}])
def test_matroska_layouts(tmp_path, layout):
    """Hand-muxed Matroska: BlockGroups, Xiph / EBML / fixed-size lacing
    (fixed with frames of one size: raw I420), several Clusters, unknown
    sizes."""
    w, h = 24, 16
    frames = scene(w, h, 9, 5)
    if layout.get("lacing") == "fixed":
        data = [yuv420p(f) for f in frames]
        kw = {"codec_id": "V_UNCOMPRESSED", "colour_space": b"I420"}
    else:
        data = [jpeg(f) for f in frames]
        kw = {}
    path = _write(tmp_path, mux_mkv(data, w, h, **kw, **layout), "clip.mkv")
    assert same_as_cv2(path) == 5


def test_matroska_vfw_fourccs(tmp_path):
    """V_MS/VFW/FOURCC: the BITMAPINFOHEADER's fourcc picks the decoder
    (I420 here), as in an AVI."""
    w, h = 22, 14
    bih = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 12, b"I420",
                      rawvideo.frame_size(w, h), 0, 0, 0, 0)
    frames = [yuv420p(f) for f in scene(w, h, 10, 3)]
    path = _write(tmp_path, mux_mkv(frames, w, h, "V_MS/VFW/FOURCC", bih),
                  "clip.mkv")
    assert same_as_cv2(path) == 3


@pytest.mark.parametrize("ext,fourcc,match", [
    ("mp4", "mp4v", "MP4 with MPEG-4 Part 2"),
    ("mkv", "mp4v", "Matroska.*MPEG-4 Part 2"),
    ("webm", "VP80", "VP8"), ("webm", "VP90", "VP9"),
    ("mkv", "VP90", "VP9"), ("mp4", "VP90", "MP4 with VP9"),
    ("avi", "FFVH", "FFVH"), ("mkv", "FFVH", "FFVH"),
    ("avi", "VP80", "VP8")])
def test_container_refusals_name_the_codec(tmp_path, ext, fourcc, match):
    """Codecs cv2 reads from these containers and the port does not:
    UnsupportedVideo naming the container and the codec.  MPEG-4 Part 2
    VP8 and VP9 are read since they have decoders: the MPEG-4 cases hold a
    VOL that asks for OBMC (which FFmpeg ignores and the port refuses), the
    VP8 ones key frames of version 4 (which FFmpeg decodes as version 1-3
    and the port refuses), the VP9 ones key frames of color_space BT.709
    (which cv2 converts with BT.709's matrix and the port refuses), named
    with the container and the codec."""
    path = str(tmp_path / f"clip.{ext}")
    write_cv2_clip(path, scene(32, 16, 1, 2), fourcc)
    if fourcc == "mp4v":
        with open(path, "rb") as f:
            data = set_vol_bit(f.read(), "obmc_disable", 0)
        with open(path, "wb") as f:
            f.write(data)
    if fourcc == "VP90":
        with open(path, "rb") as f:
            data = set_vp9_color_space(f.read(), 2)
        with open(path, "wb") as f:
            f.write(data)
    if fourcc == "VP80":
        with open(path, "rb") as f:
            data = bytearray(f.read())
        at = data.find(b"\x9d\x01\x2a")
        while at >= 0:              # the frame tag 3 bytes before
            data[at - 3] = (data[at - 3] & ~0x0E) | (4 << 1)
            at = data.find(b"\x9d\x01\x2a", at + 1)
        with open(path, "wb") as f:
            f.write(data)
    assert len(cv2_frames(path)) == 2
    with pytest.raises(UnsupportedVideo, match=match):
        list(VideoReader(path))


@pytest.mark.parametrize("name,fourcc", [
    ("clip.mp4", "FFV1"), ("clip.mkv", "I420"), ("clip.avi", "0"),
    ("clip.mp4", "MPNG")])
@pytest.mark.parametrize("target", [None, (48, 40)])
def test_series_reader_on_containers_equals_jax(tmp_path, name, fourcc,
                                                target):
    """ImageSeriesReader on these sources: JAX's stems (None) and frames,
    with and without target_wh."""
    path = str(tmp_path / name)
    write_cv2_clip(path, scene(64, 48, 11, 3), fourcc)
    got = list(ImageSeriesReader(path, target).iter_named())
    want = list(JaxReader(path, target).iter_named())
    assert [s for s, _ in got] == [s for s, _ in want] == [None] * 3
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_cut_and_empty_containers_do_not_open(tmp_path):
    """An MP4 without moov, a Matroska file with no video track: OSError
    as the JAX reader's (cv2 does not open them)."""
    frames = [jpeg(f) for f in scene(24, 16, 2, 2)]
    mp4 = mux_mp4(frames, 24, 16)
    paths = [_write(tmp_path, mp4[:mp4.index(b"moov") - 4], "cut.mp4"),
             _write(tmp_path, mux_mkv(frames, 24, 16, track_type=2),
                    "audio.mkv")]
    for path in paths:
        assert cv2_frames(path) == []
        with pytest.raises(OSError, match="cannot open video source"):
            VideoReader(path)
        with pytest.raises(OSError, match="cannot open video source"):
            JaxReader(path)
    assert os.path.exists(paths[0])
