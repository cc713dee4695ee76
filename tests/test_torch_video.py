"""The port's video reader against ``cv2.VideoCapture`` and the JAX
package: ``io/video.VideoReader`` (``io/avi``, ``io/mjpeg``, ``io/ffv1``)
gives cv2's frames bit for bit, and as many, on AVIs written at test time by
``cv2.VideoWriter`` (FFmpeg's Motion JPEG and FFV1 encoders, and OpenCV's
own Motion JPEG writer) and hand-muxed from ``cv2.imencode`` JPEGs (every
sampling factor, odd sizes, no DHT, restarts, progressive, idx1, OpenDML,
AVIX, JUNK, ``LIST rec``, zero-length chunks, ``CS=ITU601``); the committed
clips of ``tests/data/torch_video`` still decode to the digests recorded
there; the refusals name what they refuse; ``ImageSeriesReader`` and
``acquire_series`` / ``acq`` on a video equal the JAX package's (depth
paired by position); and a subprocess reads a video and runs ``acq`` from
it without loading jax, flax, cv2 or the JAX package."""

import contextlib
import io
import json
import os
import struct
import subprocess
import sys

import cv2
import numpy as np
import pytest

from fealess_tpu.apps import acquire as jax_acquire
from fealess_tpu.apps import cli as jax_cli
from fealess_tpu.io.series import ImageSeriesReader as JaxReader
from fealess_tpu_torch.apps import acquire, cli
from fealess_tpu_torch.io.series import ImageSeriesReader
from fealess_tpu_torch.io.video import UnsupportedVideo, VideoReader
from tests.make_torch_video import (OUT, committed_sources, cut_dht,
                                    cv2_frames, digest, jpeg, mux_avi, scene,
                                    set_vol_bit, set_vp9_color_space,
                                    sha256, write_cv2_clip,
                                    write_ffmpeg_clip)
from tests.test_torch_io import LOADED

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, Q = cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_QUALITY
SAMPLING = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}


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


def _write(tmp_path, data: bytes, name: str = "clip.avi") -> str:
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


def _frames(kind: str, w: int, h: int, seed: int, n: int):
    if kind == "noise":
        rng = np.random.default_rng(seed)
        return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                for _ in range(n)]
    return scene(w, h, seed, n)


@pytest.mark.parametrize("fourcc,w,h,kind,seed,n", [
    ("MJPG", 64, 48, "scene", 0, 3),
    ("MJPG", 640, 480, "scene", 1, 2),
    ("MJPG", 34, 18, "noise", 2, 3),
    ("MJPG", 2, 2, "noise", 3, 2),
    ("MJPG", 160, 90, "noise", 4, 2),
    ("FFV1", 64, 48, "scene", 0, 3),
    ("FFV1", 640, 480, "scene", 1, 2),
    ("FFV1", 34, 18, "noise", 2, 14),
    ("FFV1", 2, 2, "noise", 3, 2),
    ("FFV1", 96, 64, "noise", 5, 3),
])
def test_cv2_writer_clips_bitwise(tmp_path, fourcc, w, h, kind, seed, n):
    """FFmpeg's encoders under cv2.VideoWriter (FFV1 past its 12-frame
    group: non-key frames keep the context states)."""
    path = str(tmp_path / "clip.avi")
    frames = _frames(kind, w, h, seed, n)
    if n > 3:
        frames[3] = np.zeros_like(frames[3])
    write_cv2_clip(path, frames, fourcc)
    assert _same_as_cv2(path) == n
    if fourcc == "FFV1":            # lossless: the frames written
        for got, want in zip(VideoReader(path), frames):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("quality,w,h", [(30, 64, 48), (95, 64, 48),
                                         (75, 50, 30)])
def test_opencv_mjpeg_writer_bitwise(tmp_path, quality, w, h):
    """OpenCV's own Motion JPEG writer (CAP_OPENCV_MJPEG)."""
    path = str(tmp_path / "clip.avi")
    vw = cv2.VideoWriter(path, cv2.CAP_OPENCV_MJPEG,
                         cv2.VideoWriter_fourcc(*"MJPG"), 10, (w, h),
                         [cv2.VIDEOWRITER_PROP_QUALITY, quality])
    assert vw.isOpened()
    for f in scene(w, h, quality, 3):
        vw.write(f)
    vw.release()
    assert _same_as_cv2(path) == 3


def _mjpegs(sampling, w, h, quality, seed, n=2, *params, kind="scene"):
    frames = _frames(kind, w, h, seed, n)
    if sampling == "gray":
        return [jpeg(cv2.cvtColor(f, cv2.COLOR_BGR2GRAY), Q, quality,
                     *params) for f in frames]
    return [jpeg(f, Q, quality, S, SAMPLING[sampling], *params)
            for f in frames]


@pytest.mark.parametrize("sampling", ["420", "422", "444", "gray"])
@pytest.mark.parametrize("case", ["q5-noise", "q50", "q100-noise", "nodht",
                                  "restart", "progressive", "17x34", "1x1",
                                  "33x2", "1x2", "17x33", "640x480"])
def test_hand_muxed_mjpeg_bitwise(tmp_path, sampling, case):
    """imencode JPEGs muxed by hand: every sampling factor and quality,
    odd sizes, the DHT cut as UVC cameras send frames, restart markers,
    progressive frames."""
    w, h, params, quality, kind = 64, 48, (), 90, "scene"
    if case.startswith("q"):
        quality = int(case[1:].split("-")[0])
        kind = "noise" if case.endswith("noise") else "scene"
    elif case == "restart":
        params = (cv2.IMWRITE_JPEG_RST_INTERVAL, 2)
    elif case == "progressive":
        params = (cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    elif "x" in case:
        w, h = (int(v) for v in case.split("x"))
    frames = _mjpegs(sampling, w, h, quality, 7, 2, *params, kind=kind)
    if case == "nodht":
        frames = [cut_dht(f) for f in frames]
    path = _write(tmp_path, mux_avi(frames, w, h))
    assert _same_as_cv2(path) == 2


@pytest.mark.parametrize("layout", [
    {"index": "idx1"}, {"index": "none"}, {"index": "odml"},
    {"index": "odml", "split": 2}, {"index": "idx1", "split": 3},
    {"index": "none", "split": 1, "junk": True},
    {"index": "idx1", "junk": True}, {"index": "odml", "rec": True},
    {"index": "none", "rec": True}, {"fourcc": b"AVRn"},
    {"fourcc": b"dmb1"}, {"fourcc": b"mjpg"}])
def test_avi_layouts(tmp_path, layout):
    """The demuxer's indexes and chunk layouts, and the Motion JPEG
    fourccs."""
    frames = _mjpegs("422", 64, 48, 85, 11, 5)
    path = _write(tmp_path, mux_avi(frames, 64, 48, **layout))
    assert _same_as_cv2(path) == 5


@pytest.mark.parametrize("index", ["idx1", "odml", "none"])
def test_zero_length_chunk_yields_no_frame(tmp_path, index):
    """A zero-length frame chunk: FFmpeg leaves it out of its index, and
    cv2 returns no frame for it."""
    frames = _mjpegs("420", 64, 48, 85, 3, 3)
    path = _write(tmp_path, mux_avi([frames[0], b"", frames[1], frames[2]],
                                    64, 48, index=index))
    assert _same_as_cv2(path) == 3


def _with_comment(data: bytes, text: bytes, after_sof: bool = False) -> bytes:
    com = b"\xff\xfe" + struct.pack(">H", len(text) + 3) + text + b"\0"
    if not after_sof:
        return data[:2] + com + data[2:]
    at = data.index(b"\xff\xc0")
    at += 2 + struct.unpack(">H", data[at + 2:at + 4])[0]
    return data[:at] + com + data[at:]


@pytest.mark.parametrize("sampling", ["420", "422", "444"])
@pytest.mark.parametrize("where", [0, 1, "after-sof"])
@pytest.mark.parametrize("w,h", [(64, 48), (17, 33), (16, 33)])
def test_itu601_comment_is_sticky(tmp_path, sampling, where, w, h):
    """A "CS=ITU601" comment switches FFmpeg's decoder to limited-range
    planes from that frame on (after the SOF: from the next frame on), on
    every swscale path."""
    frames = _mjpegs(sampling, w, h, 90, 5, 3)
    if where == "after-sof":
        frames[1] = _with_comment(frames[1], b"CS=ITU601", True)
    else:
        frames[where] = _with_comment(frames[where], b"CS=ITU601")
    path = _write(tmp_path, mux_avi(frames, w, h))
    assert _same_as_cv2(path) == 3


@pytest.mark.parametrize("sampling", ["420", "422", "444"])
@pytest.mark.parametrize("w,h", [(17, 33), (16, 33), (3, 3), (2, 1), (2, 7),
                                 (18, 7), (640, 481), (64, 47)])
def test_odd_height_mjpeg_bitwise(tmp_path, sampling, w, h):
    """Odd heights, where swscale leaves its unscaled converter: bicubic
    chroma filters, with full chroma interpolation for an odd width, and
    x86's MMX rows above the last two (C below) for an even width."""
    frames = _mjpegs(sampling, w, h, 95, 2, 1) + _mjpegs(
        sampling, w, h, 40, 3, 1, kind="noise")
    path = _write(tmp_path, mux_avi(frames, w, h))
    assert _same_as_cv2(path) == 2


def test_committed_clips_match_cv2_and_the_digests():
    """Every committed source (AVI, MP4 and Matroska files, images and
    printf patterns): cv2 still gives the recorded digests (which
    chip_smoke.py holds the port to on the card), and so does the port."""
    with open(os.path.join(OUT, "digests.json")) as f:
        digests = json.load(f)
    names = committed_sources()
    assert names == sorted(digests)
    for name in names:
        path = os.path.join(OUT, name)
        assert digest(path) == digests[name], name
        with VideoReader(path) as reader:
            got = list(reader)
        assert {"frames": len(got),
                "shapes": [list(f.shape) for f in got],
                "sha256": [sha256(f) for f in got]} == digests[name], name
    total = sum(os.path.getsize(os.path.join(dp, n))
                for dp, _, ns in os.walk(OUT) for n in ns)
    assert total < 1_500_000


def test_refusals_name_what_they_refuse(tmp_path):
    """VP9 in MP4 and in Matroska whose key frames say BT.709 (cv2
    converts them with its matrix), ASUS V1 (ASV1) in AVI, an
    MPEG-4 Part 2 clip whose VOL asks for OBMC, an interlaced
    Motion JPEG (two fields a chunk), RealMedia (a container of
    ROADMAP's demuxing queue): UnsupportedVideo naming the container, the
    fourcc or the kind; a missing file, a file
    of no known container and an AVI with no video stream: OSError as the
    JAX reader's; a camera index: ValueError.  MS MPEG-4 v3 (DIV3) and
    WMV8 (WMV2) in AVI, refused here until the port read them, give cv2's
    frames."""
    frames = scene(64, 48, 1, 2)
    mp4, mkv, asv1, obmc = (str(tmp_path / n) for n in (
        "a.mp4", "a.mkv", "a.avi", "obmc.avi"))
    for path in (mp4, mkv):
        write_cv2_clip(path, frames, "VP90")
        with open(path, "rb") as f:
            data = set_vp9_color_space(f.read(), 2)
        with open(path, "wb") as f:
            f.write(data)
    write_cv2_clip(asv1, frames, "ASV1")
    write_cv2_clip(obmc, frames, "XVID")
    with open(obmc, "r+b") as f:             # FFmpeg ignores the bit
        data = bytearray(f.read())
        data[:] = set_vol_bit(bytes(data), "obmc_disable", 0)
        f.seek(0)
        f.write(data)
    for path, match in ((mp4, "MP4 with VP9"), (mkv, "Matroska.*VP9"),
                        (asv1, "ASV1"), (obmc, "AVI with MPEG-4 Part 2 "
                                               ".*OBMC")):
        assert len(cv2_frames(path)) == 2
        with pytest.raises(UnsupportedVideo, match=match):
            list(VideoReader(path))
    fields = [jpeg(f[::2]) + jpeg(f[1::2]) for f in frames]
    inter = _write(tmp_path, mux_avi(fields, 64, 48), "fields.avi")
    assert len(cv2_frames(inter)) == 2
    with pytest.raises(UnsupportedVideo, match="interlaced"):
        list(VideoReader(inter))
    real = str(tmp_path / "a.rm")
    write_ffmpeg_clip(real, frames, "RV10")
    assert len(cv2_frames(real)) == 2
    with pytest.raises(UnsupportedVideo, match="RealMedia"):
        VideoReader(real)
    junk = _write(tmp_path, b"not a video at all" * 20, "junk.avi")
    audio = bytearray(mux_avi([jpeg(frames[0])], 64, 48))
    at = audio.index(b"vids")
    audio[at:at + 4] = b"auds"
    audio = _write(tmp_path, bytes(audio), "audio.avi")
    for path in (junk, audio, str(tmp_path / "missing.avi")):
        with pytest.raises(OSError, match="cannot open video source"):
            VideoReader(path)
        with pytest.raises(OSError, match="cannot open video source"):
            JaxReader(path)
    with pytest.raises(ValueError, match="camera index"):
        ImageSeriesReader(3)
    for fourcc in ("DIV3", "WMV2"):
        path = str(tmp_path / f"{fourcc}.avi")
        write_cv2_clip(path, frames, fourcc)
        want = cv2_frames(path)
        got = list(VideoReader(path))
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fourcc", ["MJPG", "FFV1"])
@pytest.mark.parametrize("target", [None, (160, 120), (64, 48)])
def test_series_reader_on_video_equals_jax(tmp_path, fourcc, target):
    """ImageSeriesReader on a video: JAX's stems (None) and frames, with
    and without target_wh (ops/resize as cv2.resize)."""
    path = str(tmp_path / "clip.avi")
    write_cv2_clip(path, scene(96, 64, 4, 3), fourcc)
    got = list(ImageSeriesReader(path, target).iter_named())
    want = list(JaxReader(path, target).iter_named())
    assert [s for s, _ in got] == [s for s, _ in want] == [None] * 3
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)
    reader = ImageSeriesReader(path)
    reader.close()
    reader.close()


def _outputs_equal(port: str, jax: str, subs=("gray", "depth", "cloud")):
    for sub in subs:
        want = sorted(os.listdir(os.path.join(jax, sub)))
        assert sorted(os.listdir(os.path.join(port, sub))) == want, sub
        assert want, sub
        for name in want:
            a, b = os.path.join(port, sub, name), os.path.join(jax, sub, name)
            if sub == "cloud":
                with open(a) as fa, open(b) as fb:
                    assert fa.read() == fb.read(), name
                continue
            got = cv2.imread(a, cv2.IMREAD_UNCHANGED)
            want_img = cv2.imread(b, cv2.IMREAD_UNCHANGED)
            assert got.dtype == want_img.dtype, name
            np.testing.assert_array_equal(got, want_img, err_msg=name)


def test_acquire_series_from_video_pairs_depth_by_position(tmp_path):
    """Both acquire_series on a cv2-written clip with a depth directory
    (more depth files than frames, numeric stems past 9): the video's
    nameless frames take depth by position; gray/ and depth/ decode to the
    same pixels, cloud/ is the same text."""
    path = str(tmp_path / "clip.avi")
    frames = scene(64, 48, 6, 3)
    write_cv2_clip(path, frames, "MJPG")
    dep = tmp_path / "depth"
    dep.mkdir()
    rng = np.random.default_rng(0)
    for stem in (0, 1, 10, 2):
        d = rng.integers(300, 1200, (48, 64)).astype(np.uint16)
        d[:5] = 0
        cv2.imwrite(str(dep / f"{stem}.png"), d)
    outs = {}
    for name, fn, extra in (("jax", jax_acquire.acquire_series, {}),
                            ("port", acquire.acquire_series,
                             {"device": "cpu"})):
        outs[name] = str(tmp_path / name)
        with contextlib.redirect_stdout(io.StringIO()):
            n = fn(path, outs[name], depth_dir=str(dep), save_clouds=True,
                   target_wh=(64, 48), **extra)
        assert n == 3
    _outputs_equal(outs["port"], outs["jax"])
    assert sorted(os.listdir(os.path.join(outs["port"], "depth"))) == \
        ["0.png", "1.png", "2.png"]
    np.testing.assert_array_equal(
        cv2.imread(os.path.join(outs["port"], "depth", "2.png"),
                   cv2.IMREAD_UNCHANGED),
        cv2.imread(str(dep / "2.png"), cv2.IMREAD_UNCHANGED))


def test_acq_cli_on_the_committed_clip_equals_jax(tmp_path):
    """acq on the committed 640x480 clip with its depth directory writes
    the pixels the JAX CLI wrote (recon.json), and the same files as the
    JAX CLI now."""
    clip = os.path.join(OUT, "clip.avi")
    dep = os.path.join(OUT, "depth")
    with open(os.path.join(OUT, "recon.json")) as f:
        want = json.load(f)["acq"]
    outs = {}
    for name, main, device in (("jax", jax_cli.main, []),
                               ("port", cli.main, ["--device", "cpu"])):
        outs[name] = str(tmp_path / name)
        with contextlib.redirect_stdout(io.StringIO()):
            assert main(["acq", clip, outs[name], "--depth-dir", dep]
                        + device) == 0
    _outputs_equal(outs["port"], outs["jax"], ("gray", "depth"))
    for sub, names in want.items():
        got = {n: sha256(cv2.imread(os.path.join(outs["port"], sub, n),
                                    cv2.IMREAD_UNCHANGED))
               for n in sorted(os.listdir(os.path.join(outs["port"], sub)))}
        assert got == names, sub


def test_acq_refuses_a_video_it_does_not_read(tmp_path, capsys):
    """acq on an ASUS V1 AVI (a codec the port does not read yet) or a
    missing path prints the reason and returns 1, writing nothing; on the
    MS MPEG-4 v3 and WMV8 AVIs it refused until the port read them, acq
    writes the JAX CLI's frames."""
    avi = str(tmp_path / "a.avi")
    write_cv2_clip(avi, scene(32, 16, 1, 2), "ASV1")
    for source, match in ((avi, "ASUS V1"),
                          (str(tmp_path / "nope.avi"), "cannot open")):
        out = str(tmp_path / "out")
        assert cli.main(["acq", source, out, "--device", "cpu"]) == 1
        assert match in capsys.readouterr().err
        assert not os.path.exists(out)
    for fourcc in ("DIV3", "WMV2"):
        clip = str(tmp_path / f"{fourcc}.avi")
        write_cv2_clip(clip, scene(32, 16, 1, 2), fourcc)
        outs = {}
        for name, main, device in (("jax", jax_cli.main, []),
                                   ("port", cli.main, ["--device", "cpu"])):
            outs[name] = str(tmp_path / f"{fourcc}_{name}")
            with contextlib.redirect_stdout(io.StringIO()):
                assert main(["acq", clip, outs[name]] + device) == 0
        _outputs_equal(outs["port"], outs["jax"], ("gray",))
        assert len(os.listdir(os.path.join(outs["port"], "gray"))) == 2


_SUBPROCESS = LOADED + r"""
import contextlib, io, json, os, sys
from fealess_tpu_torch.apps import cli
from fealess_tpu_torch.io import image2, isobmff, matroska, rawvideo  # noqa
from fealess_tpu_torch.io.video import VideoReader

clip, dep, out = sys.argv[1:4]
shapes = [list(f.shape) for f in VideoReader(clip)]
others = {name: len(list(VideoReader(os.path.join(os.path.dirname(clip),
                                                  name))))
          for name in sys.argv[4:]}
with contextlib.redirect_stdout(io.StringIO()):
    rc = cli.main(["acq", clip, out, "--depth-dir", dep, "--clouds",
                   "--device", "cpu"])
print(json.dumps({"rc": rc, "shapes": shapes, "others": others,
                  "written": sorted(os.listdir(os.path.join(out, "cloud"))),
                  "loaded": _loaded()}))
"""

# one committed source of each demuxer and decoder the subprocess reads
OTHERS = ("ffv1.mkv", "i420.avi", "mjpeg.mp4", "mpng.mkv", "images/one.bmp",
          "images/one.jpg", "seq/f_%03d.png", "m4_cut.avi", "m4_mp4v.mp4")


def test_video_and_acq_run_without_jax_flax_or_cv2(tmp_path):
    """A fresh interpreter reads the committed clip and runs acq from it
    (depth, clouds), and reads a committed source of each other demuxer
    and decoder (MP4, Matroska, raw I420, PNG video, BMP and JPEG images,
    a printf pattern, MPEG-4 Part 2); jax, flax, cv2 and the JAX package
    are never loaded."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _SUBPROCESS,
                          os.path.join(OUT, "clip.avi"),
                          os.path.join(OUT, "depth"), str(tmp_path / "acq"),
                          *OTHERS],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["loaded"] == []
    with open(os.path.join(OUT, "digests.json")) as f:
        digests = json.load(f)
    assert result["others"] == {n: digests[n]["frames"] for n in OTHERS}
    assert result["rc"] == 0
    assert result["shapes"] == [[480, 640, 3]] * 4
    assert result["written"] == ["0.txt", "1.txt", "2.txt", "3.txt"]
