"""The port's scan-package layer against the JAX package's: raw scanner
dumps converted by the port decode equal through cv2 and ``read_png``;
``iter_training_frames`` and ``load_scan_package`` give JAX's frames
(images, masks, pose13); ``train_package`` writes a YAML that both
readers read to JAX's views (and, the writer following cv::FileStorage,
the same bytes)."""

import os
import shutil

import cv2
import numpy as np
import pytest
import torch

from fealess_tpu.apps import scan_package as jax_scan
from fealess_tpu.io import linemod_yaml as jax_yaml
from fealess_tpu_torch.apps import scan_package
from fealess_tpu_torch.io import linemod_yaml
from fealess_tpu_torch.io.png import read_png, write_png
from tests.test_match_e2e import make_scene
from tests.test_torch_config import to_port
from tests.test_torch_io import _assert_same_classes, adam7_png

torch.set_num_threads(1)

SHIFTS = ((0, 0), (10, 5), (-6, 3))


def write_package(d, shifts=SHIFTS, tie_free=True):
    """The reference training-package layout, written with the port's
    writers: gray/ and depth/ pngs (depth x10, 0.1 mm units), pose/ and
    view/ txts; frame i is make_scene's scene rolled by shifts[i].  With
    ``tie_free`` the object's green is 3/4 of the blue's complement (see
    tests/test_torch_track.py)."""
    bgr, depth, mask = make_scene(np.random.default_rng(7))
    if tie_free:
        bgr[mask, 1] = (255 - bgr[mask, 0].astype(np.int32)) * 3 // 4
    for sub in ("gray", "depth", "pose", "view"):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
    for i, (dx, dy) in enumerate(shifts):
        b = np.roll(np.roll(bgr, dy, axis=0), dx, axis=1)
        z = np.roll(np.roll(depth, dy, axis=0), dx, axis=1)
        write_png(os.path.join(d, "gray", f"{i}.png"), b)
        write_png(os.path.join(d, "depth", f"{i}.png"),
                  (z.astype(np.uint32) * 10).astype(np.uint16))
        pose = np.eye(3, 4, dtype=np.float32)
        pose[:, 3] = (0.5 * dx, 0.25 * dy, 0.0)
        with open(os.path.join(d, "pose", f"{i}.txt"), "w") as fh:
            fh.write(" ".join(str(v) for v in pose.reshape(-1)) + "\n")
        with open(os.path.join(d, "view", f"{i}.txt"), "w") as fh:
            fh.write("# header\n# header2\n650.0\n")
    return bgr, depth


@pytest.fixture(scope="module")
def package(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("pkg"))
    write_package(d)
    return d


def _assert_same_frame(got, want):
    assert got.index == want.index
    for k in ("bgr", "depth_mm", "mask", "pose13"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_convert_raw_package_matches_jax(tmp_path):
    """The port's conversion of one raw dump decodes, through cv2 and
    through read_png, to JAX's conversion of the same dump."""
    rng = np.random.default_rng(0)
    h, w = 48, 64
    depth = rng.uniform(0, 7000, size=(h, w)).astype(np.float32)
    depth[0, :3] = (-5.0, 6553.6, 1e9)           # clipped to 0 and 65535
    rgba = rng.integers(0, 256, size=(h, w, 4), dtype=np.uint8)
    dirs = {}
    for name, conv in (("port", scan_package.convert_raw_package),
                       ("jax", jax_scan.convert_raw_package)):
        d = str(tmp_path / name)
        for sub in ("gray", "depth"):
            os.makedirs(os.path.join(d, sub))
        depth.tofile(os.path.join(d, "depth", "0.raw"))
        rgba.tofile(os.path.join(d, "gray", "0.raw"))
        assert conv(d, width=w, height=h) == 1
        assert not os.path.exists(os.path.join(d, "depth", "0.raw"))
        dirs[name] = d
    for sub, flag in (("depth", cv2.IMREAD_UNCHANGED),
                      ("gray", cv2.IMREAD_COLOR)):
        want = cv2.imread(os.path.join(dirs["jax"], sub, "0.png"), flag)
        path = os.path.join(dirs["port"], sub, "0.png")
        for got in (cv2.imread(path, flag), read_png(path, color=sub == "gray")):
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(read_png(os.path.join(
        dirs["port"], "gray", "0.png")), rgba[:, :, [2, 1, 0]])


def test_iter_training_frames_matches_jax(package):
    got = list(scan_package.iter_training_frames(package))
    want = list(jax_scan.iter_training_frames(package))
    assert len(got) == len(want) == len(SHIFTS)
    for g, w in zip(got, want):
        _assert_same_frame(g, w)
    assert got[0].pose13[12] == 650.0 and got[1].pose13[3] == 5.0
    assert not got[0].mask[0, 0] and got[0].mask[80, 120]


def test_iter_training_frames_stops_at_missing_files(tmp_path):
    d = str(tmp_path)
    write_package(d, shifts=SHIFTS[:2])
    os.remove(os.path.join(d, "view", "1.txt"))
    assert [f.index for f in scan_package.iter_training_frames(d)] == \
        [f.index for f in jax_scan.iter_training_frames(d)] == [0]


def _truncate(path):
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[:len(data) // 2])


def test_scan_package_stops_at_undecodable_png(tmp_path):
    """Frame 2's gray PNG is cut in half: iter_training_frames and
    load_scan_package end the package there, as JAX's do (frame 3 is
    never read)."""
    d = str(tmp_path)
    write_package(d, shifts=SHIFTS + ((2, 2),))
    _truncate(os.path.join(d, "gray", "2.png"))
    got = list(scan_package.iter_training_frames(d))
    want = list(jax_scan.iter_training_frames(d))
    assert [f.index for f in got] == [f.index for f in want] == [0, 1]
    for g, w in zip(got, want):
        _assert_same_frame(g, w)
    got = scan_package.load_scan_package(d).frames
    want = jax_scan.load_scan_package(d).frames
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _assert_same_frame(g, w)


def test_scan_package_refuses_interlaced_png(tmp_path):
    """An Adam7-interlaced frame or mask PNG, which cv2 (and so JAX) reads,
    is read as JAX reads it: the frame stays in the package (the loader
    neither ends there nor refuses it), and an interlaced colour mask
    (gray levels through IMREAD_GRAYSCALE, a gAMA chunk too) and 16-bit
    mask are read, not counted as absent.  (The name is kept from when
    the port refused such files.)"""
    frame, mask = str(tmp_path / "frame"), str(tmp_path / "mask")
    write_package(frame)
    write_package(mask)
    path = os.path.join(frame, "gray", "1.png")
    bgr = cv2.imread(path)
    with open(path, "wb") as f:
        f.write(adam7_png(np.ascontiguousarray(bgr[:, :, ::-1]),
                          filters=[0, 1, 2, 3, 4]))
    np.testing.assert_array_equal(cv2.imread(path), bgr)
    got = list(scan_package.iter_training_frames(frame))
    want = list(jax_scan.iter_training_frames(frame))
    assert [f.index for f in got] == [f.index for f in want] == [0, 1, 2]
    for g, w in zip(got, want):
        _assert_same_frame(g, w)
    os.makedirs(os.path.join(mask, "mask"))
    rng = np.random.default_rng(8)
    rgb = rng.integers(0, 10, (160, 240, 3)).astype(np.uint8)
    m16 = rng.integers(0, 600, (160, 240)).astype(np.uint16)
    with open(os.path.join(mask, "mask", "0.png"), "wb") as f:
        f.write(adam7_png(rgb, chunks=[(b"gAMA", bytes.fromhex("0000b18f"))]))
    with open(os.path.join(mask, "mask", "1.png"), "wb") as f:
        f.write(adam7_png(m16))
    got = scan_package.load_scan_package(mask).frames
    want = jax_scan.load_scan_package(mask).frames
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _assert_same_frame(g, w)
    np.testing.assert_array_equal(got[1].mask, m16 >= 256)
    sentinel = list(scan_package.iter_training_frames(mask))[0].mask
    assert not np.array_equal(got[0].mask, sentinel)


def test_load_scan_package_matches_jax(tmp_path):
    """GL projection, bounding box and mask pngs overriding the
    depth-sentinel mask: 8- and 16-bit gray, an RGB and an RGBA mask (read
    as cv2's IMREAD_GRAYSCALE reads them, small values so that libpng's
    gray rounding decides ``> 0``), and a corrupt mask, which leaves the
    sentinel mask."""
    d = str(tmp_path)
    write_package(d, shifts=SHIFTS + ((2, 2), (-3, -1)))
    with open(os.path.join(d, "colorCameraGLProjection.txt"), "w") as fh:
        fh.write(" ".join(str(0.5 * i) for i in range(16)) + "\n")
    with open(os.path.join(d, "volumeData.txt"), "w") as fh:
        fh.write("-1 1 -2 2 -3 3\n")
    os.makedirs(os.path.join(d, "mask"))
    rng = np.random.default_rng(4)
    m8 = (rng.random((160, 240)) < 0.5).astype(np.uint8) * 255
    m16 = rng.integers(0, 600, (160, 240)).astype(np.uint16)
    write_png(os.path.join(d, "mask", "0.png"), m8)
    write_png(os.path.join(d, "mask", "2.png"), m16)
    rgb = rng.integers(0, 10, (160, 240, 3)).astype(np.uint8)
    rgb[0, :3] = ((1, 0, 0), (0, 0, 1), (0, 0, 9))     # B, G, R: 0, 0, 1
    rgba = rng.integers(0, 10, (160, 240, 4)).astype(np.uint8)
    assert cv2.imwrite(os.path.join(d, "mask", "1.png"), rgb)
    assert cv2.imwrite(os.path.join(d, "mask", "3.png"), rgba)
    write_png(os.path.join(d, "mask", "4.png"), m8)
    _truncate(os.path.join(d, "mask", "4.png"))
    got = scan_package.load_scan_package(d, obj_tag="box")
    want = jax_scan.load_scan_package(d, obj_tag="box")
    assert got.obj_tag == want.obj_tag == "box"
    np.testing.assert_array_equal(got.gl_projection, want.gl_projection)
    np.testing.assert_array_equal(got.bounding_box, want.bounding_box)
    assert len(got.frames) == len(want.frames) == 5
    for g, w in zip(got.frames, want.frames):
        _assert_same_frame(g, w)
    np.testing.assert_array_equal(got.frames[2].mask, m16 >= 256)
    assert got.frames[1].mask[0, :3].tolist() == [False, False, True]
    assert not got.frames[1].mask.all() and got.frames[1].mask.any()
    sentinel = list(scan_package.iter_training_frames(d))[4].mask
    np.testing.assert_array_equal(got.frames[4].mask, sentinel)


def test_train_package_matches_jax(tmp_path, package):
    """train_package on copies of one package (three masked frames in one
    chunk, plus a frame whose mask is empty, which takes the single-view
    path and fails): the same counts, and the YAML reads to JAX's views
    through both readers."""
    dirs = {}
    for name in ("port", "jax"):
        dirs[name] = str(tmp_path / name)
        shutil.copytree(package, dirs[name])
        # frame 3: depth[0, 0] nearest of all, so the sentinel mask is empty
        z = read_png(os.path.join(package, "depth", "0.png"))
        z[0, 0] = 0
        write_png(os.path.join(dirs[name], "depth", "3.png"), z)
        for sub in ("gray", "pose", "view"):
            ext = "png" if sub == "gray" else "txt"
            shutil.copy(os.path.join(package, sub, f"0.{ext}"),
                        os.path.join(dirs[name], sub, f"3.{ext}"))
    got = scan_package.train_package(dirs["port"], class_id="box",
                                     device="cpu")
    want = jax_scan.train_package(dirs["jax"], class_id="box")
    assert got == want == (3, 4)
    yml = {k: os.path.join(v, "linemod_templates.yml")
           for k, v in dirs.items()}
    det_w, cls_w = jax_yaml.load_linemod(yml["jax"])
    for reader, want in ((jax_yaml.load_linemod, det_w),
                         (linemod_yaml.load_linemod, to_port(det_w))):
        det_g, cls_g = reader(yml["port"])
        assert det_g == want
        _assert_same_classes(cls_g, cls_w)
    with open(yml["port"], "rb") as a, open(yml["jax"], "rb") as b:
        assert a.read() == b.read()
