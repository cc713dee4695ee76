"""The port's training path against the JAX package's: ``add_template``
and ``add_templates_batched`` give views equal to JAX's element for
element, on the host's numpy path and on its native path; the fixture's
view equals template 0 of the in-repo YAML bank, which the JAX package
wrote; the greedy selection, the chessboard chamfer and both extractors
equal JAX's on random inputs made from a seed.

The native cases build ``libfealess_host`` themselves, once per module,
from ``native/fealess_host`` into a temporary directory of their own, and
load it through ``fealess_tpu_torch.io.native`` by its path; they skip
only where cmake, ninja or a C++ compiler is missing."""

import os
import shutil
import subprocess

import cv2
import numpy as np
import pytest
import torch

from fealess_tpu import config as cfg
from fealess_tpu import training as jax_training
from fealess_tpu.ops import image as jax_image
from fealess_tpu_torch import training
from fealess_tpu_torch.io import linemod_yaml
from fealess_tpu_torch.io import native
from fealess_tpu_torch.io.png import read_png
from tests.test_match_e2e import H, W, make_scene
from tests.test_torch_config import to_port

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "benchmarks", "reference", "out")


@pytest.fixture(scope="module")
def native_lib(tmp_path_factory):
    """Path of a libfealess_host built for this module: ``cmake -G Ninja``
    and ``ninja`` on native/fealess_host, in a directory no other test
    writes.  Skips only when a build tool is missing."""
    missing = [t for t in ("cmake", "ninja") if shutil.which(t) is None]
    if not any(shutil.which(c) for c in ("c++", "g++", "clang++")):
        missing.append("a C++ compiler")
    if missing:
        pytest.skip(f"cannot build libfealess_host: no {', '.join(missing)}")
    build = str(tmp_path_factory.mktemp("fealess_host"))
    for cmd in (["cmake", "-S", os.path.join(REPO, "native", "fealess_host"),
                 "-B", build, "-G", "Ninja"], ["ninja", "-C", build]):
        subprocess.run(cmd, check=True, capture_output=True)
    return os.path.join(build, "libfealess_host.so")


@pytest.fixture(params=["numpy", "native"])
def host_path(request, monkeypatch):
    """Run the port's extraction on one host path: numpy, or the native
    library built by ``native_lib``, loaded by its path for this test
    only.  The JAX package takes its native path where the library is
    built (its numpy and native paths are equal, tests/test_native.py)."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_SEARCHED", True)
    if request.param == "native":
        native.load_library(request.getfixturevalue("native_lib"))
    assert training.have_native() == (request.param == "native")
    return request.param


def assert_same_view(got, want):
    assert want is not None and got is not None
    assert (got.width, got.height, got.offset_x, got.offset_y) == \
        (want.width, want.height, want.offset_x, want.offset_y)
    assert got.pose.dtype == np.float32
    np.testing.assert_array_equal(got.pose, want.pose)
    assert len(got.features) == len(want.features)
    for fl_g, fl_w in zip(got.features, want.features):
        assert len(fl_g) == len(fl_w)
        for fg, fw in zip(fl_g, fl_w):
            assert fg.dtype == np.int32 and fg.shape == fw.shape
            np.testing.assert_array_equal(fg, fw)


def _pose(view_distance=650.0):
    pose = np.zeros(13, np.float32)
    pose[0] = pose[5] = pose[10] = 1.0
    pose[3], pose[12] = 1.5, view_distance
    return pose


def test_fixture_view_equals_yaml_template0(host_path):
    """The fixture's training view (benchmarks/reference/make_fixture.py:
    the scene, mask rows 160:320 x cols 240:432, R = I, t = 0, view
    distance 800) gives template 0 of the repo's YAML bank, single and
    batched."""
    bgr = read_png(os.path.join(FIXTURE, "scene_bgr.png"))
    depth = read_png(os.path.join(FIXTURE, "scene_depth.png"))
    mask = np.zeros(depth.shape, bool)
    mask[160:320, 240:432] = True
    pose = np.zeros(13, np.float32)
    pose[0] = pose[5] = pose[10] = 1.0
    pose[12] = 800.0
    det = to_port(cfg.DetectorConfig())
    _, classes = linemod_yaml.load_linemod(
        os.path.join(FIXTURE, "features", "linemod_templates.yml"))
    want = classes["obj"][0]
    assert_same_view(training.add_template(bgr, depth, mask, pose, det,
                                           device="cpu"), want)
    batched = training.add_templates_batched([bgr], [depth], [mask], [pose],
                                             det, device="cpu", workers=1)
    assert_same_view(batched[0], want)


def _views(n):
    """n training views of the synthetic scene: shifted rolls, one with
    its mask at the frame's border."""
    bgr, depth, mask = make_scene(np.random.default_rng(7))
    shifts = [(0, 0), (-60, -40), (30, 12), (-78, 45)][:n]
    out = []
    for dx, dy in shifts:
        out.append(tuple(np.roll(np.roll(a, dy, 0), dx, 1)
                         for a in (bgr, depth, mask)))
    return out


@pytest.mark.parametrize("det", [
    cfg.DetectorConfig(image_width=W, image_height=H),
    cfg.default_line(),
    cfg.DetectorConfig(t_at_level=(5, 8, 4),
                       depth_normal=cfg.DepthNormalConfig(
                           extract_threshold=1))],
    ids=["linemod", "line", "three_levels"])
def test_add_template_matches_jax(host_path, det):
    """Single views, masked and unmasked, in the LINE-MOD, colour-only and
    three-level configurations."""
    for i, (bgr, depth, mask) in enumerate(_views(2)):
        pose = _pose(600.0 + i)
        for m in ((mask, None) if i == 0 else (mask,)):
            want = jax_training.add_template(bgr, depth, m, pose, det)
            got = training.add_template(bgr, depth, m, pose, to_port(det),
                                        device="cpu")
            if want is None:
                assert got is None
            else:
                assert_same_view(got, want)


def test_add_templates_batched_matches_jax(host_path):
    """Four views through one batched call (crops near and at the border,
    a mask too small to yield features) equal JAX's batched views and the
    port's own single-view path."""
    det = cfg.DetectorConfig(image_width=W, image_height=H)
    views = _views(4)
    tiny = np.zeros((H, W), bool)
    tiny[70:74, 100:104] = True
    views.append((views[0][0], views[0][1], tiny))
    bgrs, depths, masks = (list(a) for a in zip(*views))
    poses = [_pose(600.0 + i) for i in range(len(views))]
    got = training.add_templates_batched(bgrs, depths, masks, poses,
                                         to_port(det), device="cpu")
    want = jax_training.add_templates_batched(bgrs, depths, masks, poses,
                                              det)
    assert len(got) == len(want) == 5
    assert want[4] is None and got[4] is None
    for i in range(4):
        assert_same_view(got[i], want[i])
        assert_same_view(training.add_template(bgrs[i], depths[i], masks[i],
                                               poses[i], to_port(det),
                                               device="cpu"), want[i])


def test_batch_crop_rects_match_jax():
    rng = np.random.default_rng(3)
    masks = []
    for _ in range(6):
        m = np.zeros((H, W), bool)
        y, x = rng.integers(0, H - 8), rng.integers(0, W - 8)
        m[y:y + rng.integers(1, H - y), x:x + rng.integers(1, W - x)] = True
        masks.append(m)
    for levels in (1, 2, 3):
        assert (training._batch_crop_rects(masks, (H, W), levels)
                == jax_training._batch_crop_rects(masks, (H, W), levels))


def test_select_scattered_features_matches_jax():
    """Random candidate lists (with coordinate collisions, so the greedy
    pick shrinks its distance) against JAX's loop and the native one."""
    rng = np.random.default_rng(11)
    for trial in range(24):
        big = trial >= 20             # at a frame's extent, as in training
        k = int(rng.integers(1000, 2000) if big else rng.integers(5, 300))
        w, h = (640, 480) if big else (40, 30)
        cand = np.stack([rng.integers(0, w, k), rng.integers(0, h, k),
                         rng.integers(0, 8, k)], -1).astype(np.int32)
        nf = 63 if big else int(rng.integers(1, k + 1))
        dist = float(k // nf + 1) if big else float(rng.integers(1, 12))
        want = jax_training.select_scattered_features(cand, None, nf, dist)
        got = training.select_scattered_features(cand, None, nf, dist)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        if training.have_native():
            np.testing.assert_array_equal(
                native.select_scattered_features(cand, nf,
                                                               dist), want)


def test_chamfer_matches_jax_and_cv2():
    """The numpy chessboard chamfer on random masks equals JAX's copy,
    cv2.distanceTransform(DIST_C, 3) and the native one."""
    rng = np.random.default_rng(5)
    for shape, p in (((7, 9), 0.8), ((40, 57), 0.9), ((33, 20), 0.5),
                     ((16, 16), 1.0)):
        nz = rng.random(shape) < p
        got = training.distance_transform_chessboard(nz)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(
            got, jax_image.distance_transform_chessboard(nz))
        if not nz.all():
            np.testing.assert_array_equal(got, cv2.distanceTransform(
                nz.astype(np.uint8), cv2.DIST_C, 3))
        if training.have_native() and not nz.all():
            # (with no zero pixel at all, the native transform gives
            # 1.7e38 where the numpy one gives inf)
            np.testing.assert_array_equal(
                got, native.chamfer_chessboard(nz))


def test_erode3_matches_cv2():
    rng = np.random.default_rng(9)
    m = rng.random((30, 41)) < 0.85
    for it in (1, 2):
        want = cv2.erode(m.astype(np.uint8), np.ones((3, 3), np.uint8),
                         iterations=it, borderType=cv2.BORDER_REPLICATE)
        np.testing.assert_array_equal(training._erode3_np(m, it), want > 0)


def test_extractors_match_jax_on_random_inputs(host_path):
    """extract_gradient_template / extract_normal_template on random
    one-hot bit images, magnitudes and masks."""
    rng = np.random.default_rng(21)
    for trial in range(6):
        h, w = int(rng.integers(20, 60)), int(rng.integers(20, 60))
        bits = (1 << rng.integers(0, 8, (h, w))).astype(np.uint8)
        bits[rng.random((h, w)) < 0.3] = 0
        mag = rng.uniform(0, 9000, (h, w)).astype(np.float32)
        mask = np.zeros((h, w), bool)
        mask[3:h - 2, 4:w - 3] = rng.random((h - 5, w - 7)) < 0.95
        for m in (mask, None):
            for nf in (8, 31):
                g_w = jax_training.extract_gradient_template(bits, mag, m,
                                                             nf, 55.0)
                g_g = training.extract_gradient_template(bits, mag, m, nf,
                                                         55.0)
                n_w = jax_training.extract_normal_template(bits, m, nf, 1)
                n_g = training.extract_normal_template(bits, m, nf, 1)
                for got, want in ((g_g, g_w), (n_g, n_w)):
                    if want is None:
                        assert got is None
                    else:
                        np.testing.assert_array_equal(got, want)
