"""The port's frame input and output against the JAX package on a series
of mixed sizes: ``io.native.FrameLoader`` (threads decoding ahead, frames
resized to the first frame's size with ``ops/resize``) against JAX's
``FrameLoader`` (cv2), the CLI's ``recon`` (plain, ``--multi``,
``--overlay-dir``) and ``track`` against the JAX CLI's JSON lines and
overlay images, ``acq`` against JAX's ``acquire_series`` (gray, depth and
cloud outputs), PNG, JPEG and BMP frames read by content as cv2 reads
them (the series reader, ``acq`` and ``recon`` on a series whose
``gray/*.png`` hold JPEG data), a camera index and the videos the port
does not read refused by name,
``acq`` failing without a card, the wireframe rasteriser against
``cv2.line``, and a subprocess that runs these paths without loading
jax, flax, cv2 or the JAX package."""

import glob
import json
import os
import shutil
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from fealess_tpu.apps import acquire as jax_acquire
from fealess_tpu.apps import cli as jax_cli
from fealess_tpu.apps import model_mesh as jax_mesh
from fealess_tpu.io.native import FrameLoader as JaxLoader
from fealess_tpu_torch.apps import acquire, cli, model_mesh
from fealess_tpu_torch.io.native import FrameLoader
from fealess_tpu_torch.io.series import ImageSeriesReader
from tests.test_torch_cli import (RECON, ROI_TOL_PX, _capture, _run,
                                  _same_lines, _same_results,
                                  _write_cube_obj)
from tests.test_torch_io import LOADED, _encode_png
from tests.test_torch_scan_package import write_package

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def package(tmp_path_factory):
    """A 3-frame scan package (240x160) with a cube model, trained by the
    JAX CLI (the port's train writes the same bytes:
    tests/test_torch_cli.py)."""
    d = str(tmp_path_factory.mktemp("pkg"))
    write_package(d)
    _write_cube_obj(os.path.join(d, "model.obj"))
    rc, _ = _capture(jax_cli.main, ["train", d])
    assert rc == 0
    return d


def _scaled(img, wh, nearest=False):
    return cv2.resize(img, wh, interpolation=(cv2.INTER_NEAREST if nearest
                                              else cv2.INTER_LINEAR))


@pytest.fixture(scope="module")
def mixed_series(package, tmp_path_factory):
    """Frames of the package at other sizes: 0 as it is (240x160, the
    series size), 1 at 2x (480x320), 2 at 1.5x (360x240), 3 at half size
    (120x80: a 2-D upscale back), 4 with a colour PNG that does not
    decode, 5 = frame 0 with Paeth- and Average-filtered colour rows, 6
    with colour at 1.5x and depth at its own size."""
    d = str(tmp_path_factory.mktemp("mixed"))
    for sub in ("gray", "depth"):
        os.makedirs(os.path.join(d, sub))
    frames = [(cv2.imread(os.path.join(package, "gray", f"{i}.png")),
               cv2.imread(os.path.join(package, "depth", f"{i}.png"),
                          cv2.IMREAD_UNCHANGED)) for i in range(3)]
    sizes = [None, (480, 320), (360, 240), (120, 80), None, None, None]
    for i, wh in enumerate(sizes):
        bgr, depth = frames[i % 3]
        if wh is not None:
            bgr, depth = _scaled(bgr, wh), _scaled(depth, wh, nearest=True)
        if i == 6:
            bgr = _scaled(bgr, (360, 240))
        cv2.imwrite(os.path.join(d, "gray", f"{i}.png"), bgr)
        cv2.imwrite(os.path.join(d, "depth", f"{i}.png"), depth)
    with open(os.path.join(d, "gray", "4.png"), "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + bytes(40))
    with open(os.path.join(d, "gray", "5.png"), "wb") as f:
        f.write(_encode_png(np.ascontiguousarray(frames[2][0][:, :, ::-1]),
                            [4, 3, 4, 1]))
    return d


def _pairs(series):
    paths = cli._series_paths(series)
    return [p[0] for p in paths], [p[1] for p in paths]


@pytest.mark.parametrize("threads,capacity", [(4, 8), (8, 2), (1, 1)])
def test_frame_loader_matches_jax(mixed_series, threads, capacity):
    """In order, the undecodable pair skipped with its index kept, every
    frame resized to the first frame's size as cv2 resizes it."""
    colors, depths = _pairs(mixed_series)
    want = list(JaxLoader(colors, depths, target_wh=(240, 160)))
    got = list(FrameLoader(colors, depths, target_wh=(240, 160),
                           threads=threads, capacity=capacity))
    assert [w[0] for w in want] == [0, 1, 2, 3, 5, 6]
    assert [g[0] for g in got] == [w[0] for w in want]
    for (_, gb, gd), (_, wb, wd) in zip(got, want):
        assert gb.dtype == np.uint8 and gd.dtype == np.uint16
        np.testing.assert_array_equal(gb, wb)
        np.testing.assert_array_equal(gd, wd)


def test_frame_loader_stress_and_close(mixed_series):
    """More threads than cores on 70 pairs keeps the order; leaving early
    and closing stops the threads; without target_wh frames keep their
    size."""
    import threading
    colors, depths = _pairs(mixed_series)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        got = [i for i, _, _ in FrameLoader(colors * 10, depths * 10,
                                            target_wh=(240, 160),
                                            threads=16, capacity=5)]
    finally:
        sys.setswitchinterval(old)
    assert got == [i for i in range(70) if i % 7 != 4]
    with FrameLoader(colors, depths) as loader:
        idx, bgr, depth = next(loader)
        assert idx == 0 and bgr.shape == (160, 240, 3)
        idx, bgr, depth = next(loader)
        assert bgr.shape == (320, 480, 3) and depth.shape == (320, 480)
    assert not any(t.name.startswith("frame-loader")
                   for t in threading.enumerate())
    with pytest.raises(StopIteration):
        next(loader)
    with pytest.raises(ValueError):
        FrameLoader(colors, depths[:-1])


@pytest.fixture(scope="module")
def jax_mixed(package, mixed_series, tmp_path_factory):
    """The JAX CLI's lines on the mixed series: recon, recon --multi,
    recon --overlay-dir (with its images' directory) and track."""
    out = {}
    overlay = str(tmp_path_factory.mktemp("jax_overlay"))
    series = ["--series", mixed_series] + RECON
    for key, argv in (("recon", ["recon", package] + series),
                      ("multi", ["recon", package, "--multi"] + series),
                      ("overlay", ["recon", package, "--overlay-dir",
                                   overlay] + series),
                      ("track", ["track", package] + series)):
        rc, lines = _capture(jax_cli.main, argv)
        assert rc == 0
        out[key] = [json.loads(ln) for ln in lines if ln.startswith("{")]
    out["overlay_dir"] = overlay
    return out


@pytest.mark.parametrize("key,flags", [("recon", []), ("multi", ["--multi"])])
def test_cli_recon_mixed_sizes_matches_jax(package, mixed_series, jax_mixed,
                                           capsys, key, flags):
    rc, got, _, err = _run(cli.main, ["recon", package, "--series",
                                      mixed_series, "--device", "cpu"]
                           + flags + RECON, capsys)
    assert rc == 0 and "6 frames in" in err
    want = jax_mixed[key]
    assert [w["frame"] for w in want] == [0, 1, 2, 3, 5, 6]
    assert sum(bool(w["results"]) for w in want) >= 4
    _same_lines(got, want)


def test_cli_recon_overlay_matches_jax(package, mixed_series, jax_mixed,
                                       tmp_path, capsys):
    """--overlay-dir writes the wireframe of the first result on every
    frame with one: the images decode to the JAX CLI's."""
    overlay = str(tmp_path / "overlay")
    rc, got, _, _ = _run(cli.main, ["recon", package, "--series",
                                    mixed_series, "--overlay-dir", overlay,
                                    "--device", "cpu"] + RECON, capsys)
    assert rc == 0
    _same_lines(got, jax_mixed["overlay"])
    names = sorted(os.listdir(jax_mixed["overlay_dir"]))
    assert names and sorted(os.listdir(overlay)) == names
    assert len(names) == sum(bool(w["results"])
                             for w in jax_mixed["overlay"])
    for name in names:
        want = cv2.imread(os.path.join(jax_mixed["overlay_dir"], name))
        got_img = cv2.imread(os.path.join(overlay, name))
        assert (want == (0, 0, 255)).all(axis=2).any(), name
        np.testing.assert_array_equal(got_img, want, err_msg=name)


def test_cli_track_mixed_sizes_matches_jax(package, mixed_series, jax_mixed,
                                           capsys):
    rc, got, _, _ = _run(cli.main, ["track", package, "--series",
                                    mixed_series, "--device", "cpu"]
                         + RECON, capsys)
    assert rc == 0
    want = jax_mixed["track"]
    assert [(g["frame"], g["redetected"], g["tracking"]) for g in got] == \
        [(w["frame"], w["redetected"], w["tracking"]) for w in want]
    assert any(not w["redetected"] for w in want)
    for g, w in zip(got, want):
        if w["roi"] is None:
            assert g["roi"] is None
        else:
            np.testing.assert_allclose(g["roi"], w["roi"], atol=ROI_TOL_PX,
                                       rtol=0)
        _same_results(g["results"], w["results"])


@pytest.fixture(scope="module")
def acq_source(mixed_series, tmp_path_factory):
    """An image directory (colour PNGs of the mixed series, frame 4 not
    decodable) and a depth directory matched by stem, frame 2's depth
    missing and 3's named out of numeric order."""
    d = str(tmp_path_factory.mktemp("acq"))
    src, dep = os.path.join(d, "color"), os.path.join(d, "depth")
    shutil.copytree(os.path.join(mixed_series, "gray"), src)
    shutil.copytree(os.path.join(mixed_series, "depth"), dep)
    os.remove(os.path.join(dep, "2.png"))
    os.rename(os.path.join(src, "3.png"), os.path.join(src, "10.png"))
    os.rename(os.path.join(dep, "3.png"), os.path.join(dep, "10.png"))
    return src, dep


def test_acq_matches_jax(acq_source, tmp_path):
    """acq with depth and --clouds writes what JAX's acquire_series writes:
    the same files, gray/ and depth/ decoding to the same arrays (colour
    resized to 640x480), cloud/ the same text; the printed lines too."""
    src, dep = acq_source
    outs = {}
    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        outs[name] = str(tmp_path / name)
        device = ["--device", "cpu"] if name == "port" else []
        rc, lines = _capture(main, ["acq", src, outs[name], "--depth-dir",
                                    dep, "--clouds", "--fx", "600",
                                    "--cx", "123.5"] + device)
        assert rc == 0
        outs[name + "_lines"] = [ln.replace(outs[name], "OUT")
                                 for ln in lines]
    assert outs["port_lines"] == outs["jax_lines"]
    assert outs["jax_lines"][-1] == "saved 6 frames to OUT"
    for sub in ("gray", "depth", "cloud"):
        want = sorted(os.listdir(os.path.join(outs["jax"], sub)))
        assert sorted(os.listdir(os.path.join(outs["port"], sub))) == want
        assert want, sub
        for name in want:
            a = os.path.join(outs["port"], sub, name)
            b = os.path.join(outs["jax"], sub, name)
            if sub == "cloud":
                with open(a) as fa, open(b) as fb:
                    assert fa.read() == fb.read(), name
                continue
            got = cv2.imread(a, cv2.IMREAD_UNCHANGED)
            want_img = cv2.imread(b, cv2.IMREAD_UNCHANGED)
            assert got.dtype == want_img.dtype
            np.testing.assert_array_equal(got, want_img, err_msg=name)
    assert cv2.imread(os.path.join(outs["port"], "gray", "0.png")).shape \
        == (480, 640, 3)


def test_acq_max_frames_and_functions_match_jax(acq_source, tmp_path):
    """acquire_series with max_frames and without depth, and the ROI and
    cloud helpers, against JAX's."""
    src, dep = acq_source
    for mod, name in ((jax_acquire, "jax"), (acquire, "port")):
        n = mod.acquire_series(src, str(tmp_path / name), max_frames=2,
                               target_wh=(200, 150))
        assert n == 2
    for i in range(2):
        np.testing.assert_array_equal(
            cv2.imread(str(tmp_path / "port" / "gray" / f"{i}.png")),
            cv2.imread(str(tmp_path / "jax" / "gray" / f"{i}.png")))
    assert not os.path.exists(tmp_path / "port" / "depth")
    depth = cv2.imread(os.path.join(dep, "0.png"), cv2.IMREAD_UNCHANGED)
    for args in ((depth,), (depth, 1000.0, 0), (np.zeros_like(depth),)):
        assert acquire.roi_from_depth(*args) == \
            jax_acquire.roi_from_depth(*args)
    mask = depth < 8000
    assert acquire.roi_from_mask(mask, 3) == jax_acquire.roi_from_mask(mask, 3)
    pts = np.random.default_rng(1).normal(size=(50, 3)).astype(np.float32)
    pts[3, 1] = np.nan
    valid = np.arange(50) % 3 > 0
    acquire.write_cloud_txt(str(tmp_path / "a.txt"), pts, valid)
    jax_acquire.write_cloud_txt(str(tmp_path / "b.txt"), pts, valid)
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text()


def test_cv2_only_sources_are_refused(acq_source, tmp_path, monkeypatch,
                                      capsys):
    """A camera index needs a video device: the reader refuses it by
    name, and acq says so and returns 1; a video path that does not exist
    raises OSError as the JAX reader's does, and an ASUS V1 AVI (a codec
    the port does not read yet) raises UnsupportedVideo naming it, where
    an MS MPEG-4 v2 AVI and a WMV8 AVI give the JAX reader's frames;
    JPEG and BMP
    files are read (as the JAX reader reads them, in a directory and in a
    list); the ROI picker needs a display."""
    from fealess_tpu.io.series import ImageSeriesReader as JaxReader
    from fealess_tpu_torch.io.video import UnsupportedVideo
    with pytest.raises(ValueError, match="camera index"):
        ImageSeriesReader(0)
    clip = str(tmp_path / "clip.avi")
    with pytest.raises(OSError, match="cannot open video source"):
        ImageSeriesReader(clip)
    with pytest.raises(OSError, match="cannot open video source"):
        JaxReader(clip)
    vw = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"ASV1"), 10, (32, 16))
    for _ in range(2):
        vw.write(np.full((16, 32, 3), 90, np.uint8))
    vw.release()
    assert len(list(JaxReader(clip))) == 2
    with pytest.raises(UnsupportedVideo, match="AVI with ASUS V1"):
        ImageSeriesReader(clip)
    for fourcc in ("MP42", "WMV2"):
        path = str(tmp_path / f"{fourcc}.avi")
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), 10,
                             (32, 16))
        for k in range(2):
            vw.write(np.full((16, 32, 3), 90 + 40 * k, np.uint8))
        vw.release()
        got, want = list(ImageSeriesReader(path)), list(JaxReader(path))
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    jpg = tmp_path / "jpg"
    shutil.copytree(acq_source[0], jpg)
    cv2.imwrite(str(jpg / "7.jpg"), np.full((4, 4, 3), 90, np.uint8))
    cv2.imwrite(str(jpg / "8.bmp"), np.full((4, 4, 3), 160, np.uint8))
    for source in (str(jpg), [str(jpg / "0.png"), str(jpg / "7.jpg"),
                              str(jpg / "8.bmp")]):
        got = list(ImageSeriesReader(source, (240, 160)).iter_named())
        want = list(JaxReader(source, (240, 160)).iter_named())
        assert [s for s, _ in got] == [s for s, _ in want]
        assert {"7", "8"} <= {s for s, _ in got}
        for (_, g), (_, w) in zip(got, want):
            np.testing.assert_array_equal(g, w)
    rc, _, _, err = _run(cli.main, ["acq", "0", str(tmp_path / "out")],
                         capsys)
    assert rc == 1 and "camera index" in err
    frames = list(ImageSeriesReader([str(jpg / "1.png"), str(jpg / "nope.png"),
                                     str(jpg / "4.png"), str(jpg / "0.png")],
                                    target_wh=(240, 160)).iter_named())
    assert [s for s, _ in frames] == ["1", "0"]
    for var in ("DISPLAY", "WAYLAND_DISPLAY"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="display"):
        acquire.BoxExtractor().extract("roi", frames[0][1])


def _jpeg(img, *params):
    ok, buf = cv2.imencode(".jpg", img, list(params))
    assert ok
    return buf.tobytes()


def _with_exif(jpg: bytes, orientation: int) -> bytes:
    """``jpg`` with an Exif APP1 segment (little-endian TIFF, one entry:
    the orientation) right after SOI."""
    body = (b"Exif\0\0II*\0\x08\0\0\0\x01\0\x12\x01\x03\0\x01\0\0\0"
            + bytes([orientation]) + bytes(7))
    return (jpg[:2] + b"\xff\xe1" + (len(body) + 2).to_bytes(2, "big")
            + body + jpg[2:])


@pytest.fixture(scope="module")
def format_dir(package, tmp_path_factory):
    """A directory of the package's frames in every format the port reads,
    named as cv2 would not guess them: 0.jpg baseline 4:2:0, 1.jpeg
    progressive 4:4:4, 2.bmp 24-bit, 3.png, 4.bmp 8-bit gray palette,
    5.jpg 4:2:2 with EXIF orientation 6, 6.png holding JPEG data, 7.jpg cut
    short, 8.jpg not an image; depth/<i>.png beside them by stem."""
    d = str(tmp_path_factory.mktemp("formats"))
    src, dep = os.path.join(d, "color"), os.path.join(d, "depth")
    os.makedirs(src)
    os.makedirs(dep)
    frames = [(cv2.imread(os.path.join(package, "gray", f"{i % 3}.png")),
               cv2.imread(os.path.join(package, "depth", f"{i % 3}.png"),
                          cv2.IMREAD_UNCHANGED)) for i in range(9)]
    sf = cv2.IMWRITE_JPEG_SAMPLING_FACTOR
    blobs = {
        "0.jpg": _jpeg(frames[0][0], cv2.IMWRITE_JPEG_QUALITY, 95),
        "1.jpeg": _jpeg(frames[1][0], cv2.IMWRITE_JPEG_PROGRESSIVE, 1, sf,
                        cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444),
        "2.bmp": cv2.imencode(".bmp", frames[2][0])[1].tobytes(),
        "3.png": cv2.imencode(".png", frames[3][0])[1].tobytes(),
        "4.bmp": cv2.imencode(".bmp", frames[4][0][:, :, 1])[1].tobytes(),
        "5.jpg": _with_exif(_jpeg(frames[5][0], sf,
                                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422), 6),
        "6.png": _jpeg(frames[6][0], cv2.IMWRITE_JPEG_RST_INTERVAL, 3),
        "7.jpg": _jpeg(frames[7][0])[:-4000],
        "8.jpg": b"\xff\xd8\xff" + bytes(64),
    }
    for name, blob in blobs.items():
        with open(os.path.join(src, name), "wb") as f:
            f.write(blob)
        stem = name.split(".")[0]
        cv2.imwrite(os.path.join(dep, f"{stem}.png"), frames[int(stem)][1])
    return src, dep


@pytest.mark.parametrize("target_wh", [None, (240, 160), (640, 480)])
def test_series_reader_formats_match_jax(format_dir, target_wh):
    """The directory's frames in the JAX reader's order with its stems,
    each decoded (and resized) as cv2 does; the file that is not an image
    is skipped, the one cut short is read."""
    from fealess_tpu.io.series import ImageSeriesReader as JaxReader
    got = list(ImageSeriesReader(format_dir[0], target_wh).iter_named())
    want = list(JaxReader(format_dir[0], target_wh).iter_named())
    assert [s for s, _ in want] == [str(i) for i in range(8)]
    assert [s for s, _ in got] == [s for s, _ in want]
    for (stem, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w, err_msg=stem)
    if target_wh is None:
        assert want[5][1].shape == (240, 160, 3)         # EXIF 6: rotated


def test_acq_formats_matches_jax(format_dir, tmp_path):
    """acq over the directory of every format (depth and --clouds) writes
    JAX's files: gray/ and depth/ decoding to the same arrays, cloud/ the
    same text, the same printed lines."""
    src, dep = format_dir
    outs = {}
    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        outs[name] = str(tmp_path / name)
        device = ["--device", "cpu"] if name == "port" else []
        rc, lines = _capture(main, ["acq", src, outs[name], "--depth-dir",
                                    dep, "--clouds"] + device)
        assert rc == 0
        outs[name + "_lines"] = [ln.replace(outs[name], "OUT")
                                 for ln in lines]
    assert outs["port_lines"] == outs["jax_lines"]
    assert outs["jax_lines"][-1] == "saved 8 frames to OUT"
    for sub in ("gray", "depth", "cloud"):
        names = sorted(os.listdir(os.path.join(outs["jax"], sub)))
        assert len(names) == 8
        assert sorted(os.listdir(os.path.join(outs["port"], sub))) == names
        for name in names:
            a = os.path.join(outs["port"], sub, name)
            b = os.path.join(outs["jax"], sub, name)
            if sub == "cloud":
                with open(a) as fa, open(b) as fb:
                    assert fa.read() == fb.read(), name
                continue
            np.testing.assert_array_equal(
                cv2.imread(a, cv2.IMREAD_UNCHANGED),
                cv2.imread(b, cv2.IMREAD_UNCHANGED), err_msg=name)


def test_acq_needs_the_card_it_is_given(format_dir, tmp_path):
    """acq back-projects on --device (default cuda): where there is no
    card it fails loudly and does not carry on on the CPU."""
    args = cli.build_parser().parse_args(["acq", "src", "out"])
    assert args.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    src, dep = format_dir
    with pytest.raises((AssertionError, RuntimeError)):
        cli.main(["acq", src, str(tmp_path / "out"), "--depth-dir", dep,
                  "--clouds"])
    with pytest.raises((AssertionError, RuntimeError)):
        acquire.acquire_series(src, str(tmp_path / "out2"), dep,
                               save_clouds=True)


@pytest.fixture(scope="module")
def jpeg_series(package, tmp_path_factory):
    """The package's frames as a series whose ``gray/<i>.png`` hold JPEG
    data (baseline 4:2:0, progressive, and 4:4:4 with restart markers),
    depth as PNG; and the JAX CLI's recon lines on it."""
    d = str(tmp_path_factory.mktemp("jpeg_series"))
    for sub in ("gray", "depth"):
        os.makedirs(os.path.join(d, sub))
    params = ([], [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
              [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
               cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
               cv2.IMWRITE_JPEG_RST_INTERVAL, 2])
    for i, extra in enumerate(params):
        bgr = cv2.imread(os.path.join(package, "gray", f"{i}.png"))
        with open(os.path.join(d, "gray", f"{i}.png"), "wb") as f:
            f.write(_jpeg(bgr, cv2.IMWRITE_JPEG_QUALITY, 95, *extra))
        shutil.copy(os.path.join(package, "depth", f"{i}.png"),
                    os.path.join(d, "depth", f"{i}.png"))
    rc, lines = _capture(jax_cli.main, ["recon", package, "--series", d]
                         + RECON)
    assert rc == 0
    return d, [json.loads(ln) for ln in lines if ln.startswith("{")]


def test_cli_recon_jpeg_content_matches_jax(package, jpeg_series, capsys):
    """recon over ``gray/*.png`` files that hold JPEG data: cv2 reads them
    by content, so JAX serves every frame; the port must too, with the
    same lines (a reader that goes by the name drops them all)."""
    series, want = jpeg_series
    assert [w["frame"] for w in want] == [0, 1, 2]
    assert sum(bool(w["results"]) for w in want) >= 2
    rc, got, _, err = _run(cli.main, ["recon", package, "--series", series,
                                      "--device", "cpu"] + RECON, capsys)
    assert rc == 0 and "3 frames in" in err
    _same_lines(got, want)


def test_draw_wireframe_matches_jax(tmp_path):
    """The numpy rasteriser equals cv2.line (LINE_8, thickness 1, clipped)
    on random lines far outside the image, and draw_wireframe equals
    JAX's on a cube seen from poses that put it partly out of view."""
    rng = np.random.default_rng(4)
    for t in range(3000):
        w, h = (int(v) for v in rng.integers(1, 90, 2))
        span = (3, 40, 400, 40000)[t % 4]
        p1, p2 = ([int(v) for v in rng.integers(-span, span, 2)]
                  for _ in range(2))
        want = np.zeros((h, w, 3), np.uint8)
        cv2.line(want, tuple(p1), tuple(p2), (0, 0, 255))
        got = np.zeros((h, w, 3), np.uint8)
        xs, ys = model_mesh.line_pixels(w, h, p1, p2)
        got[ys, xs] = (0, 0, 255)
        np.testing.assert_array_equal(got, want, err_msg=f"{p1} {p2}")
    obj = str(tmp_path / "cube.obj")
    _write_cube_obj(obj)
    mesh = model_mesh.load_obj(obj, model_scale=0.1)
    k = np.array([[608.0, 0, 120.0], [0, 608.0, 80.0], [0, 0, 1]])
    for tz, tx in ((650.0, 0.0), (900.0, 310.0), (2000.0, -40.0)):
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = cv2.Rodrigues(np.array([0.3, -0.2, 0.1]))[0]
        pose[:3, 3] = (tx, 12.5, tz)
        img = rng.integers(0, 256, (160, 240, 3), dtype=np.uint8)
        want = jax_mesh.draw_wireframe(img.copy(), mesh, k, pose)
        got = model_mesh.draw_wireframe(img.copy(), mesh, k, pose)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            model_mesh.project_vertices(mesh, k, pose[:3, :3], pose[:3, 3]),
            jax_mesh.project_vertices(mesh, k, pose[:3, :3], pose[:3, 3]))


_SUBPROCESS = LOADED + r"""
import contextlib, io, json, os, sys
from fealess_tpu_torch.apps import cli
from fealess_tpu_torch.io.native import FrameLoader

pkg, series, out = sys.argv[1:4]
recon = ["--refine-crop", "64", "--icp-max-points", "1024", "--device", "cpu",
         "--series", series]
paths = cli._series_paths(series)
frames = [i for i, _, _ in FrameLoader([p[0] for p in paths],
                                       [p[1] for p in paths],
                                       target_wh=(240, 160))]
with contextlib.redirect_stdout(io.StringIO()):
    rcs = [cli.main(["recon", pkg, "--overlay-dir", os.path.join(out, "ov")]
                    + recon),
           cli.main(["track", pkg] + recon),
           cli.main(["acq", os.path.join(series, "gray"),
                     os.path.join(out, "acq"), "--depth-dir",
                     os.path.join(series, "depth"), "--clouds",
                     "--device", "cpu"])]
print(json.dumps({"rcs": rcs, "frames": frames,
                  "overlays": len(os.listdir(os.path.join(out, "ov"))),
                  "loaded": _loaded()}))
"""


def test_frames_and_acq_run_without_jax_flax_or_cv2(package, mixed_series,
                                                     tmp_path):
    """A fresh interpreter streams the mixed series through FrameLoader
    and runs recon --overlay-dir, track and acq on it; jax, flax, cv2 and
    the JAX package (by name or by file) are never loaded."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _SUBPROCESS, package,
                          mixed_series, str(tmp_path)], capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["loaded"] == []
    assert result["rcs"] == [0, 0, 0]
    assert result["frames"] == [0, 1, 2, 3, 5, 6]
    assert result["overlays"] >= 1
    assert len(glob.glob(str(tmp_path / "acq" / "cloud" / "*.txt"))) == 6
