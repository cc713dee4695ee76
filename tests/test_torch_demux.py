"""What ``cv2.VideoCapture`` reads with no new decoder, held to cv2 on the
CPU: YUV4MPEG2 (``io/y4m``), the MPEG video elementary stream
(``io/mpegvideo`` into ``io/mpeg2``), raw gray / NV12 / RGBA
(``io/rawvideo``) in AVI, Matroska and MOV, AVI's ``jpeg`` / ``LJPG`` /
``GEOX``, MOV's MPEG-2 tags, raw Motion JPEG and PNG images back to back
(``io/image2``'s parsers), and the containers ``io/video`` names by their
signatures.  cv2 is the JAX reader's reader (``fealess_tpu/io/series.py``
opens a file with ``cv2.VideoCapture``); one YUV4MPEG2 source also goes
through both packages' ``ImageSeriesReader``.  The committed sources of
``tests/data/torch_raw`` (``python -m tests.make_torch_video raw``) are
held to the digests chip_smoke.py holds the card to, and ``acq`` from its
640x480 YUV4MPEG2 clip, then ``recon``, to the JAX CLI's recorded output.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import struct

import cv2
import numpy as np
import pytest

from fealess_tpu.io.series import ImageSeriesReader as JaxReader
from fealess_tpu_torch.apps import cli
from fealess_tpu_torch.io import image2, mpegvideo, y4m
from fealess_tpu_torch.io.series import ImageSeriesReader
from fealess_tpu_torch.io.video import (QUEUED_CONTAINERS, UnsupportedVideo,
                                        VideoReader)
from tests.make_torch_video import (OUT, RAW_OUT, RAW_RECON_SOURCES, _shifted,
                                    cv2_frames, digest, jpeg, mux_avi, nv12,
                                    padded_rows, raw_committed_sources, scene,
                                    set_vol_width, sha256, write_ffmpeg_clip,
                                    y4m as y4m_bytes, yuv420p)
from tests.test_torch_containers import mux_mkv


def _write(tmp_path, data: bytes, name: str) -> str:
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


def _same_as_cv2(path: str) -> int:
    """Assert the port's frames equal cv2's, as many; return the count."""
    want = cv2_frames(path)
    with VideoReader(path) as reader:
        got = list(reader)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, i
        np.testing.assert_array_equal(g, w, err_msg=f"frame {i}")
    return len(want)


def _opens(path: str) -> bool:
    cap = cv2.VideoCapture(path)
    try:
        return cap.isOpened()
    finally:
        cap.release()


def test_committed_raw_sources_match_cv2_and_the_digests():
    """Every committed source of tests/data/torch_raw: cv2 still gives the
    recorded digests (which chip_smoke.py holds the port to on the card),
    and so does the port."""
    with open(os.path.join(RAW_OUT, "digests.json")) as f:
        digests = json.load(f)
    names = raw_committed_sources()
    assert names == sorted(digests)
    for name in names:
        path = os.path.join(RAW_OUT, name)
        assert digest(path) == digests[name], name
        with VideoReader(path) as reader:
            got = list(reader)
        assert {"frames": len(got),
                "shapes": [list(f.shape) for f in got],
                "sha256": [sha256(f) for f in got]} == digests[name], name
    total = sum(os.path.getsize(os.path.join(RAW_OUT, n)) for n in names)
    assert total < 1_500_000


# ---- YUV4MPEG2 ----

@pytest.mark.parametrize("colour", ["C420jpeg", "C420", "", "C420mpeg2",
                                    "C420paldv", "Cmono"])
@pytest.mark.parametrize("size", [(17, 33), (95, 62), (94, 63), (6, 4),
                                  (1, 1)])
def test_y4m_colour_spaces_and_odd_sizes_match_cv2(tmp_path, colour, size):
    """4:2:0 under each siting and gray, at odd and even widths and
    heights: cv2's frames, or (4:2:0 sited left or top-left at an odd
    height, which cv2 converts through swscale's scaler with that siting)
    refused by name."""
    w, h = size
    frames = scene(w, h, 70, 2)
    planes = [cv2.cvtColor(f, cv2.COLOR_BGR2GRAY).tobytes()
              if colour == "Cmono" else yuv420p(f) for f in frames]
    path = _write(tmp_path, y4m_bytes(planes, w, h, colour), "x.y4m")
    if colour in ("C420mpeg2", "C420paldv") and h & 1:
        assert len(cv2_frames(path)) == 2
        with pytest.raises(UnsupportedVideo, match=f"{colour} at an odd"):
            VideoReader(path)
        return
    assert _same_as_cv2(path) == 2


@pytest.mark.parametrize("extra", ["", " XCOLORRANGE=FULL",
                                   " XCOLORRANGE=LIMITED", " XYSCSS=420JPEG"])
@pytest.mark.parametrize("colour", ["C420jpeg", "Cmono"])
def test_y4m_colour_range(tmp_path, extra, colour):
    """XCOLORRANGE=FULL converts 4:2:0 at full range; gray is copied into
    B, G and R in every range."""
    frames = scene(34, 20, 71, 2)
    planes = [cv2.cvtColor(f, cv2.COLOR_BGR2GRAY).tobytes()
              if colour == "Cmono" else yuv420p(f) for f in frames]
    path = _write(tmp_path, y4m_bytes(planes, 34, 20, colour, extra),
                  "x.y4m")
    assert _same_as_cv2(path) == 2


@pytest.mark.parametrize("case", [
    "frame_params", "long_frame_line", "frame_line_past_80", "bad_magic",
    "cut_last", "header_only_last", "header_128", "header_129",
    "tokens_in_any_order", "unknown_tokens", "yscss_gray", "two_widths"])
def test_y4m_frame_lines_and_header_tokens(tmp_path, case):
    """FRAME parameters are skipped; a FRAME line past 80 bytes or not
    starting FRAME, and a frame cut short, end the stream; the header is
    read as yuv4_read_header reads it (128 bytes at most, tokens in any
    order, strtol on W and H, the last of a repeated token)."""
    w, h = 34, 20
    planes = [yuv420p(f) for f in scene(w, h, 72, 3)]
    frame_line, head = b"FRAME\n", None
    data = None
    if case == "frame_params":
        frame_line = b"FRAME Ip A1:1 XFOO=bar\n"
    elif case == "long_frame_line":
        frame_line = b"FRAME" + b" X" * 37 + b"\n"         # 80 bytes
    elif case == "frame_line_past_80":
        frame_line = b"FRAME" + b" X" * 37 + b"Y\n"        # 81 bytes
    elif case == "header_128":
        head = b"YUV4MPEG2 W34 H20 X" + b"A" * 108 + b"\n"
    elif case == "header_129":
        head = b"YUV4MPEG2 W34 H20 X" + b"A" * 109 + b"\n"
    elif case == "tokens_in_any_order":
        head = b"YUV4MPEG2 C420jpeg H20 A0:0 F30000:1001 W34 Ip\n"
    elif case == "unknown_tokens":
        head = b"YUV4MPEG2 W34 Zab H20 Q C420jpeg\n"
    elif case == "yscss_gray":
        head = b"YUV4MPEG2 W34 H20 XYSCSS=MONO\n"
    elif case == "two_widths":
        head = b"YUV4MPEG2 W17 H20 W34\n"
    if head is not None:
        data = head + b"".join(b"FRAME\n" + p for p in planes)
    else:
        data = y4m_bytes(planes, w, h, frame_line=frame_line)
    if case == "bad_magic":
        at = data.index(b"FRAME", 100)
        data = data[:at] + b"FRAMX" + data[at + 5:]
    elif case == "cut_last":
        data = data[:-1]
    elif case == "header_only_last":
        data += b"FRAME\n"
    path = _write(tmp_path, data, "x.y4m")
    if case == "header_129":
        assert not _opens(path)
        with pytest.raises(OSError, match="cannot open video source"):
            VideoReader(path)
        return
    n = _same_as_cv2(path)
    assert n == {"bad_magic": 1, "cut_last": 2, "frame_line_past_80": 0
                 }.get(case, 3), case


@pytest.mark.parametrize("colour", ["C444", "C422", "C411", "C444alpha",
                                    "C420p10", "Cmono16", "C444p16"])
def test_y4m_other_colour_spaces_are_refused_by_name(tmp_path, colour):
    """Colour spaces FFmpeg reads and the port does not: cv2 opens the
    file, the port names the colour space."""
    path = _write(tmp_path, y4m_bytes([bytes(34 * 20 * 8)] * 2, 34, 20,
                                      colour), "x.y4m")
    assert _opens(path)
    with pytest.raises(UnsupportedVideo, match=f"YUV4MPEG2 of .*{colour}"):
        VideoReader(path)


@pytest.mark.parametrize("head,match", [
    (b"YUV4MPEG2 W34 H20 It\n", "interlaced"),
    (b"YUV4MPEG2 W34 H20 Ib\n", "interlaced"),
    (b"YUV4MPEG2 W34 H20 Im\n", None), (b"YUV4MPEG2 W34 H20 Iq\n", None),
    (b"YUV4MPEG2 W34 H20 Cxyz\n", None), (b"YUV4MPEG2 W0 H20\n", None),
    (b"YUV4MPEG2 W-34 H20\n", None), (b"YUV4MPEG2 H20\n", None),
    (b"YUV4MPEG2W34 H20\n", None), (b"YUV4MPEG3 W34 H20\n", None)])
def test_y4m_headers_cv2_refuses_or_the_port_names(tmp_path, head, match):
    """Interlaced streams (swscale refuses their frames under cv2): named;
    a header FFmpeg refuses (mixed or unknown interlacing, an unknown
    colour space, no or no positive size, a bad magic): OSError, as cv2
    does not open the file."""
    plane = yuv420p(scene(34, 20, 73, 1)[0])
    path = _write(tmp_path, head + (b"FRAME\n" + plane) * 2, "x.y4m")
    if match:
        assert _opens(path)
        with pytest.raises(UnsupportedVideo, match=match):
            VideoReader(path)
        return
    assert not _opens(path)
    with pytest.raises(OSError, match="cannot open video source"):
        VideoReader(path)


def test_y4m_through_both_series_readers(tmp_path):
    """A YUV4MPEG2 source through the port's ImageSeriesReader and the JAX
    package's, with and without target_wh: the same stems and frames."""
    path = str(tmp_path / "clip.y4m")
    write_ffmpeg_clip(path, scene(64, 48, 74, 3), "I420")
    for target in (None, (48, 40)):
        got = list(ImageSeriesReader(path, target).iter_named())
        want = list(JaxReader(path, target).iter_named())
        assert [s for s, _ in got] == [s for s, _ in want] == [None] * 3
        for (_, g), (_, w) in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_y4m_header_parser_reads_what_the_writer_writes(tmp_path):
    path = str(tmp_path / "w.y4m")
    write_ffmpeg_clip(path, scene(96, 64, 75, 2), "Y800")
    with open(path, "rb") as f:
        assert f.readline() == (b"YUV4MPEG2 W96 H64 F10:1 Ip A0:0 C420jpeg "
                                b"XYSCSS=420JPEG\n")
    with y4m.Y4mFile(path) as s:
        assert (s.width, s.height, s.fmt, s.full_range) == (
            96, 64, "yuv420p", False)
        assert len(list(s.frames())) == 2


# ---- the MPEG video elementary stream ----

@pytest.fixture(scope="module")
def m2v(tmp_path_factory):
    """cv2.VideoWriter's MPEG-2 elementary stream of a 12-frame pan (I, P
    and B pictures) and its packets as the parser cuts them."""
    path = str(tmp_path_factory.mktemp("m2v") / "pan.m2v")
    base = scene(96, 64, 76, 1)[0]
    write_ffmpeg_clip(path, [_shifted(base, 3 * i, -2 * i)
                             for i in range(12)], "MPG2")
    with open(path, "rb") as f:
        data = f.read()
    return data, mpegvideo.packets(data)


def test_m2v_packets_are_the_encoders_pictures(m2v):
    """The parser cuts the stream where FFmpeg's encoder ended each
    picture: the sequence and GOP headers go with the picture after them,
    every packet holds one picture, and the packets join to the stream."""
    data, packets = m2v
    assert b"".join(packets) == data and len(packets) == 12
    for p in packets:
        assert p.count(b"\x00\x00\x01\x00") == 1
        assert p.startswith((b"\x00\x00\x01\xb3", b"\x00\x00\x01\x00"))


@pytest.mark.parametrize("case", [
    "plain", "two_streams", "seq_end_mid", "seq_end_last", "cut_in_headers",
    "cut_before_first_slice", "leading_zeros"])
def test_m2v_edits_match_cv2(tmp_path, m2v, case):
    """The stream, two streams the first closed by a sequence end code,
    a sequence end code mid-stream and at the end, the last picture cut
    inside its headers or just before its first slice (no frame from it;
    the last anchor is drained after it), zero bytes before the first
    start code: cv2's frames."""
    data, packets = m2v
    last = packets[-1]
    cut = len(data) - len(last)
    edits = {
        "plain": data,
        "two_streams": data + b"\x00\x00\x01\xb7" + data,
        "seq_end_mid": b"".join(packets[:6]) + b"\x00\x00\x01\xb7"
        + b"".join(packets[6:]),
        "seq_end_last": data + b"\x00\x00\x01\xb7",
        "cut_in_headers": data[:cut + last.index(b"\x00\x00\x01\x00") + 6],
        "cut_before_first_slice": data[:cut + last.index(
            b"\x00\x00\x01\x01")],
        "leading_zeros": b"\x00\x00\x00" + data}
    path = _write(tmp_path, edits[case], "x.m2v")
    assert _same_as_cv2(path) == {"two_streams": 24, "cut_in_headers": 11,
                                  "cut_before_first_slice": 11}.get(case, 12)


@pytest.mark.parametrize("cut", [1, 40, "half"])
def test_m2v_last_picture_cut_in_its_slices_ends_the_reader(tmp_path, m2v,
                                                           cut):
    """The last picture cut inside its slices: FFmpeg conceals the
    macroblocks it lacks (or drops a slice cut too short) and cv2 goes on
    and drains, which no reader can match; the port gives cv2's frames
    before the cut picture and ends there."""
    data, packets = m2v
    n = len(packets[-1]) // 2 if cut == "half" else cut
    path = _write(tmp_path, data[:-n], "x.m2v")
    want = cv2_frames(path)
    with VideoReader(path) as reader:
        got = list(reader)
    assert len(got) == 10 and len(want) >= 10
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_m2v_mpeg1_is_refused_by_name(tmp_path, m2v):
    """The stream without its sequence extensions is MPEG-1 syntax, which
    cv2 reads and the port names."""
    data, _ = m2v
    at = data.index(b"\x00\x00\x01\xb5")
    ext = data[at:data.index(b"\x00\x00\x01", at + 4)]
    assert ext[4] >> 4 == 1                            # sequence extension
    path = _write(tmp_path, data.replace(ext, b""), "x.m2v")
    assert _opens(path)
    with pytest.raises(UnsupportedVideo, match="MPEG-1"):
        list(VideoReader(path))


def test_m2v_frame_end_follows_ffmpegs_parser_on_field_pictures():
    """A picture coding extension with picture_structure 1 (a top field)
    keeps the packet open over the second field, as
    ff_mpeg1_find_frame_end's field states do; a frame picture (3) does
    not."""
    def picture(structure: int) -> bytes:
        ext = bytes([0x8F, 0xFF, 0xF0 | structure, 0x80])
        return (b"\x00\x00\x01\x00\x00\x0f\xff\xf8" + b"\x00\x00\x01\xb5"
                + ext + b"\x00\x00\x01\x01\x22\x33")
    frame = picture(3)
    stream = frame + frame
    assert mpegvideo.frame_end(stream, 0, len(stream)) == len(frame)
    fields = picture(1) + picture(2) + frame
    assert mpegvideo.frame_end(fields, 0, len(fields)) == \
        len(picture(1)) * 2


# ---- raw gray, NV12 and RGBA ----

@pytest.mark.parametrize("fourcc", ["Y800", "Y8  ", "GREY", "NV12", "RGBA"])
@pytest.mark.parametrize("size", [(17, 33), (18, 9), (1, 1), (2, 3),
                                  (95, 62), (64, 48)])
@pytest.mark.parametrize("layout", ["exact", "padded", "i420"])
def test_raw_avi_rows_and_padding_match_cv2(tmp_path, fourcc, size, layout):
    """Hand-muxed raw AVIs: packets of the frame's exact size, of rows
    padded to 4 bytes (gray, NV12's two planes), and of a yuv420p frame
    (what cv2.VideoWriter stores under Y800 and NV12): cv2's frames, rows
    read at the stride FFmpeg's rawvideo decoder takes for the packet."""
    w, h = size
    frames = scene(w, h, 77, 2)
    ch = (h + 1) // 2
    if fourcc == "RGBA":
        packets = [cv2.cvtColor(f, cv2.COLOR_BGR2RGBA).tobytes()
                   for f in frames]
    elif layout == "i420":
        packets = [yuv420p(f) for f in frames]
    elif fourcc == "NV12":
        packets = [nv12(f) for f in frames]
        if layout == "padded":
            packets = [padded_rows(p, [(h, w), (ch, w + (w & 1))])
                       for p in packets]
    else:
        packets = [cv2.cvtColor(f, cv2.COLOR_BGR2GRAY).tobytes()
                   for f in frames]
        if layout == "padded":
            packets = [padded_rows(p, [(h, w)]) for p in packets]
    path = _write(tmp_path, mux_avi(packets, w, h, fourcc=fourcc.encode()),
                  "raw.avi")
    assert _same_as_cv2(path) == 2


def test_y800_keeps_full_range_values(tmp_path):
    """Gray bytes 0..255 (outside the limited range) come back in B, G and
    R as stored, with no range expansion, as cv2 gives them."""
    ramp = np.arange(256, dtype=np.uint8).reshape(16, 16)
    path = _write(tmp_path, mux_avi([ramp.tobytes(), ramp[::-1].tobytes()],
                                    16, 16, fourcc=b"Y800"), "ramp.avi")
    assert _same_as_cv2(path) == 2
    first = next(iter(VideoReader(path)))
    for c in range(3):
        np.testing.assert_array_equal(first[:, :, c], ramp)


@pytest.mark.parametrize("colour", [b"Y800", b"GREY", b"NV12", b"RGBA"])
@pytest.mark.parametrize("size", [(17, 33), (20, 9)])
def test_raw_matroska_matches_cv2(tmp_path, colour, size):
    """Matroska V_UNCOMPRESSED with these colour spaces at odd and even
    sizes."""
    w, h = size
    frames = scene(w, h, 78, 2)
    if colour == b"RGBA":
        blocks = [cv2.cvtColor(f, cv2.COLOR_BGR2RGBA).tobytes()
                  for f in frames]
    elif colour == b"NV12":
        blocks = [nv12(f) for f in frames]
    else:
        blocks = [cv2.cvtColor(f, cv2.COLOR_BGR2GRAY).tobytes()
                  for f in frames]
    path = _write(tmp_path, mux_mkv(blocks, w, h, "V_UNCOMPRESSED",
                                    colour_space=colour), "raw.mkv")
    assert _same_as_cv2(path) == 2


def test_raw_packet_short_of_the_frame_ends_the_reader(tmp_path):
    """A packet shorter than the frame: FFmpeg's decoder rejects it and
    cv2's read stops there."""
    frames = scene(24, 16, 79, 3)
    packets = [nv12(f) for f in frames]
    packets[1] = packets[1][:-1]
    path = _write(tmp_path, mux_avi(packets, 24, 16, fourcc=b"NV12"),
                  "short.avi")
    assert _same_as_cv2(path) == 1


# ---- AVI tags and MOV's MPEG-2 tags ----

@pytest.mark.parametrize("ext,fourcc", [
    ("avi", "jpeg"), ("avi", "LJPG"), ("avi", "GEOX"), ("mov", "xd5b"),
    ("mov", "mp2v"), ("mov", "RGBA"), ("avi", "xd5b")])
def test_writer_tags_read_as_cv2(tmp_path, ext, fourcc):
    path = str(tmp_path / f"x.{ext}")
    write_ffmpeg_clip(path, scene(96, 64, 80, 4), fourcc)
    assert _same_as_cv2(path) == 4


@pytest.mark.parametrize("fourcc", [b"GEOX", b"GEOV"])
@pytest.mark.parametrize("width", [96, 95])
def test_geovision_mpeg4_is_upside_down_as_in_cv2(tmp_path, fourcc, width):
    """FFmpeg turns MPEG-4 Part 2 under GeoVision's tags upside down; an
    odd width (the VOL edited) too."""
    path = str(tmp_path / "g.avi")
    write_ffmpeg_clip(path, scene(96, 64, 81, 3), "GEOX")
    with open(path, "rb") as f:
        data = f.read().replace(b"GEOX", fourcc)
    if width != 96:
        data = set_vol_width(data, width)
    path = _write(tmp_path, data, "g.avi")
    assert _same_as_cv2(path) == 3


# ---- image pipes ----

def _pngs(n: int, w: int = 40, h: int = 30):
    out = [cv2.imencode(".png", f)[1].tobytes() for f in scene(w, h, 82, n)]
    gray = cv2.cvtColor(scene(w, h, 83, 1)[0], cv2.COLOR_BGR2GRAY)
    out[-1] = cv2.imencode(".png", gray)[1].tobytes()
    return out


@pytest.mark.parametrize("case", ["three", "junk_between", "trailing_junk",
                                  "cut_last", "iend_missing", "gray16"])
@pytest.mark.parametrize("name", ["x.bin", "x.png", "x.jpg"])
def test_png_pipe_matches_cv2(tmp_path, case, name):
    """PNG images back to back, under any name (png_pipe outbids image2):
    split as FFmpeg's png parser splits them; a packet the decoder rejects
    (junk before a PNG, a chunk cut short) ends the stream."""
    p = _pngs(3)
    data = {"three": b"".join(p),
            "junk_between": p[0] + b"xyz" + p[1] + p[2],
            "trailing_junk": b"".join(p) + b"trail",
            "cut_last": b"".join(p)[:-5],
            "iend_missing": b"".join(p)[:-12],
            "gray16": p[0] + cv2.imencode(".png", (np.arange(1200).reshape(
                30, 40) * 37).astype(np.uint16))[1].tobytes() + p[1]}[case]
    path = _write(tmp_path, data, name)
    assert _same_as_cv2(path) == {"junk_between": 1, "cut_last": 2
                                  }.get(case, 3)


@pytest.mark.parametrize("name", ["x.mjpeg", "x.mjpg", "x.bin", "x"])
@pytest.mark.parametrize("case", ["four", "junk_between", "sizes"])
def test_raw_mjpeg_matches_cv2(tmp_path, name, case):
    """JPEG images back to back under a name image2 does not take: split
    as FFmpeg's mjpeg parser splits them (bytes between two images go with
    the first)."""
    frames = scene(48, 32, 84, 4)
    j = [jpeg(f) for f in frames]
    data = {"four": b"".join(j),
            "junk_between": j[0] + b"\x00\x11\xff" + b"".join(j[1:]),
            "sizes": j[0] + jpeg(frames[1][:24, :40]) + j[2]}[case]
    path = _write(tmp_path, data, name)
    if case == "sizes":
        with pytest.raises(UnsupportedVideo, match="differ in size"):
            list(VideoReader(path))
        return
    assert _same_as_cv2(path) == 4


def test_jpeg_packets_split_the_writers_raw_mjpeg(tmp_path):
    path = str(tmp_path / "w.mjpeg")
    write_ffmpeg_clip(path, scene(64, 48, 85, 5), "MJPG")
    with open(path, "rb") as f:
        data = f.read()
    packets = image2.jpeg_packets(data)
    assert len(packets) == 5 and b"".join(packets) == data
    assert all(p.startswith(b"\xff\xd8") for p in packets)
    assert _same_as_cv2(path) == 5


# ---- PAM, PGM and the containers named by signature ----

def test_pam_opens_and_reads_no_frame(tmp_path):
    """cv2.imwrite's PAM (no TUPLTYPE line) under an image name: cv2 opens
    it and reads no frame (FFmpeg's PNM header parser refuses it), so the
    JAX reader yields nothing; so do the port's reader and
    ImageSeriesReader."""
    path = str(tmp_path / "x.pam")
    assert cv2.imwrite(path, scene(40, 30, 86, 1)[0])
    assert _opens(path) and cv2_frames(path) == []
    assert list(VideoReader(path)) == []
    assert list(ImageSeriesReader(path)) == list(JaxReader(path)) == []


def test_pgm_is_named_and_a_missing_pgm_does_not_open(tmp_path):
    """A gray PGM opens in cv2 and gives one frame: the port names the
    format.  cv2.imwrite writes no PGM from a colour image, and the path
    it did not write does not open: OSError in both readers."""
    img = scene(40, 30, 87, 1)[0]
    gray = str(tmp_path / "g.pgm")
    assert cv2.imwrite(gray, cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))
    assert len(cv2_frames(gray)) == 1
    with pytest.raises(UnsupportedVideo, match="PNM"):
        VideoReader(gray)
    colour = str(tmp_path / "c.pgm")
    assert not cv2.imwrite(colour, img) and not os.path.exists(colour)
    assert not _opens(colour)
    with pytest.raises(OSError, match="cannot open video source"):
        VideoReader(colour)
    with pytest.raises(OSError, match="cannot open video source"):
        JaxReader(colour)


@pytest.mark.parametrize("ext,fourcc,name", [
    ("nut", "FFV1", "NUT"), ("nut", "MJPG", "NUT"),
    ("m2ts", "MPG2", "BDAV MPEG transport stream"),
    ("ts", "MPG2", "MPEG transport stream"),
    ("mpg", "MPG2", "MPEG program stream"), ("rm", "RV10", "RealMedia"),
    ("swf", "FLV1", "SWF"), ("drc", "drac", "raw Dirac"),
    ("ogv", "VP80", "Ogg"), ("flv", "VP90", "FLV"), ("asf", "MJPG", "ASF")])
def test_containers_are_named_by_signature(tmp_path, ext, fourcc, name):
    """Containers cv2 opens and reads: those the port does not demux yet
    (QUEUED_CONTAINERS) raise UnsupportedVideo naming the container, never
    OSError; the others are read to cv2's frames."""
    w, h = (128, 96)
    path = str(tmp_path / f"x.{ext}")
    write_ffmpeg_clip(path, scene(w, h, 88, 4), fourcc)
    want = cv2_frames(path)
    assert len(want) == 4
    if name in QUEUED_CONTAINERS:
        with pytest.raises(UnsupportedVideo, match=f": {name} is read by"):
            VideoReader(path)
        return
    got = list(VideoReader(path))
    assert len(got) == 4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_container_signatures_on_hand_made_heads():
    """The signatures, on heads made by hand: a 188-byte transport stream,
    a 192-byte BDAV one, a program stream after zero bytes (each now
    picks its demuxer), the queued containers by name."""
    from fealess_tpu_torch.io.mpegps import is_mpeg_ps
    from fealess_tpu_torch.io.mpegts import packet_layout
    from fealess_tpu_torch.io.video import _container
    ts = (b"\x47" + bytes(187)) * 2
    bdav = (bytes(4) + b"\x47" + bytes(187)) * 2
    assert packet_layout(ts) == (188, 0)
    assert packet_layout(bdav) == (192, 4)
    assert is_mpeg_ps(b"\x00\x00\x00\x01\xba" + bytes(20))
    assert _container(ts) is _container(bdav) is None
    assert _container(b".RMF\x00\x00") == "RealMedia"
    assert _container(b"CWS\x0a") == _container(b"ZWS\x0a") == "SWF"
    assert _container(bytes(16)) is None


# ---- acq and recon from the committed YUV4MPEG2 clip ----

def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(argv)
    return rc, [json.loads(ln) for ln in out.getvalue().splitlines()
                if ln.startswith("{")]


@pytest.fixture(scope="module")
def y4m_package(tmp_path_factory):
    """acq from the 640x480 YUV4MPEG2 clip with the committed depth
    directory (its first two frames, paired by position)."""
    pkg = str(tmp_path_factory.mktemp("y4m") / "pkg")
    rc, _ = _run(["acq", os.path.join(RAW_OUT, "pan_y4m.y4m"), pkg,
                  "--depth-dir", os.path.join(OUT, "depth"), "--device",
                  "cpu"])
    assert rc == 0
    return pkg


def test_acq_from_the_y4m_clip_writes_the_jax_pixels(y4m_package):
    with open(os.path.join(RAW_OUT, "recon.json")) as f:
        want = json.load(f)["sources"]["pan_y4m.y4m"]
    for sub, names in want["acq"].items():
        got = {n: sha256(cv2.imread(os.path.join(y4m_package, sub, n),
                                    cv2.IMREAD_UNCHANGED))
               for n in sorted(os.listdir(os.path.join(y4m_package, sub)))}
        assert got == names, sub


def test_recon_on_the_y4m_package_equals_the_jax_cli(y4m_package):
    """recon on what acq wrote from the YUV4MPEG2 clip prints the JAX
    CLI's lines in the default ICP setting (a); the forced setting (b) is
    held on the card (chip_smoke phase 7f)."""
    from fealess_tpu_torch.apps import fixture
    from tests.test_torch_cli import _same_lines
    with open(os.path.join(RAW_OUT, "recon.json")) as f:
        want = json.load(f)["sources"]["pan_y4m.y4m"]
    frames = RAW_RECON_SOURCES["pan_y4m.y4m"]
    rc, lines = _run(["recon", os.path.join(fixture.FIXTURE, "features"),
                      "--series", y4m_package, "--device", "cpu"])
    assert rc == 0 and len(lines) == frames
    _same_lines(lines, want["a"][:frames])


def test_padded_rows_lays_rows_out_as_stated():
    assert padded_rows(bytes(range(6)), [(2, 3)]) == \
        b"\x00\x01\x02\x00\x03\x04\x05\x00"
    planes = struct.pack("6B", 1, 2, 3, 4, 5, 6)
    assert padded_rows(planes, [(1, 2), (1, 4)]) == \
        b"\x01\x02\x00\x00\x03\x04\x05\x06"


def test_chip_smoke_raw_part_rehearses_on_cpu(monkeypatch, capsys):
    """chip_smoke.py's phase 7f part for these readers, its acq and recon
    set aside: every committed source to its digests, the elementary
    stream joined from the MPEG-2 AVI's packets cut back into them and
    decoded to the AVI's frames, and the host times printed."""
    import chip_smoke
    calls = []
    monkeypatch.setattr(chip_smoke, "acq_recon_source",
                        lambda *a, **k: calls.append(a[4:6]))
    chip_smoke.raw_sources(None, "cpu rehearsal", None, None)
    assert calls == [("pan_y4m.y4m", RAW_RECON_SOURCES["pan_y4m.y4m"])]
    out = capsys.readouterr().out
    with open(os.path.join(RAW_OUT, "digests.json")) as f:
        assert f"{len(json.load(f))} committed sources" in out
    assert "YUV4MPEG2 (pan_y4m.y4m, 2 frames)" in out
    assert "MPEG-2 elementary stream" in out
