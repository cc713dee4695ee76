"""The port's training path against the JAX package's: ``add_template``
and ``add_templates_batched`` give views equal to JAX's element for
element, on the host's numpy path and on its native path; the fixture's
view equals template 0 of the in-repo YAML bank, which the JAX package
wrote; the greedy selection, the chessboard chamfer and both extractors
equal JAX's on random inputs made from a seed.

The native cases load ``libfealess_host`` as the port builds it at first
use (``ops/_build.build_native_host``: ``scatter.cc``, ``chamfer.cc`` and
``extract.cc`` of ``native/fealess_host`` with the host C++ compiler into
``build/fealess_tpu_torch/``), through ``fealess_tpu_torch.io.native`` by
its path; they skip only where no C++ compiler exists.  The numpy cases
set that library aside (``native._LIB = None``, ``native._SEARCHED =
True``), the only way the port's numpy twin runs.

The batched front-end (``quantize_crops``: each level's ops once over all
crops) equals the serving front-end run crop by crop, bit for bit, and
its launches do not grow with the batch; the front-end functions called
on one image take the launches they took before they accepted a batch."""

import os

import cv2
import numpy as np
import pytest
import torch

from fealess_tpu import config as cfg
from fealess_tpu import training as jax_training
from fealess_tpu.ops import image as jax_image
from fealess_tpu_torch import training
from fealess_tpu_torch.apps import fixture
from fealess_tpu_torch.io import linemod_yaml
from fealess_tpu_torch.io import native
from fealess_tpu_torch.io.png import read_png
from fealess_tpu_torch.ops import _build
from fealess_tpu_torch.ops import image as fi
from fealess_tpu_torch.ops import quantize as q
from tests.test_match_e2e import H, W, make_scene
from tests.test_torch_config import to_port

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "benchmarks", "reference", "out")


def _need_cxx():
    try:
        _build._host_cxx()
    except RuntimeError as e:
        pytest.skip(f"cannot build libfealess_host: {e}")


@pytest.fixture(scope="module")
def native_lib():
    """Path of libfealess_host as the port builds it at first use
    (``_build.build_native_host``; test workers share it under the
    build's lock).  Skips only when no C++ compiler exists."""
    _need_cxx()
    return str(_build.build_native_host())


@pytest.fixture(params=["numpy", "native"])
def host_path(request, monkeypatch):
    """Run the port's extraction on one host path: the numpy twin, or the
    native library built by ``native_lib``, loaded by its path for this
    test only.  The JAX package takes its native path where the library is
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


def test_load_library_builds_three_sources_into_the_port_build_dir(
        monkeypatch, tmp_path):
    """Without a path, the first ``load_library`` builds the library from
    scatter.cc, chamfer.cc and extract.cc (no frame loader) into the
    port's build directory and loads it; a second call loads the same."""
    _need_cxx()
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_SEARCHED", False)
    assert _build.NATIVE_SOURCES == ("scatter.cc", "chamfer.cc",
                                     "extract.cc")
    lib = native.load_library()
    assert lib is not None and training.have_native()
    built = sorted((tmp_path / "build").glob("libfealess_host_*.so"))
    assert len(built) == 1
    for name in native._SIGNATURES:
        assert hasattr(lib, name), name
    assert not hasattr(lib, "fealess_loader_create")
    assert native.load_library() is lib
    assert _build.build_native_host() == built[0]


def test_failed_native_build_raises_and_nothing_falls_back(monkeypatch,
                                                           tmp_path):
    """Sources that do not compile raise with the compiler's errors, at
    the library's load and at the extraction that needs it: no numpy
    fallback."""
    _need_cxx()
    src = tmp_path / "src"
    src.mkdir()
    for name in _build.NATIVE_SOURCES:
        (src / name).write_text("int broken( {\n")
    monkeypatch.setattr(_build, "NATIVE_HOST", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_SEARCHED", False)
    with pytest.raises(RuntimeError, match="failed"):
        native.load_library()
    bits = np.full((8, 8), 4, np.uint8)
    with pytest.raises(RuntimeError, match="broken"):
        training.extract_normal_template(bits, None, 4, 1)
    assert not native._SEARCHED and native._LIB is None


@pytest.fixture(scope="module")
def pan_chunk():
    """A chunk of panned fixture frames as phase 4d of chip_smoke.py feeds
    the trainer (masks: nearer than the frame's corner), and the JAX
    package's batched views of it."""
    bgr = read_png(os.path.join(FIXTURE, "scene_bgr.png"))
    depth = read_png(os.path.join(FIXTURE, "scene_depth.png"))
    frames = fixture.pan(bgr, depth, 6)
    bgrs = [b for b, _ in frames]
    depths = [d for _, d in frames]
    masks = [d < d[0, 0] for d in depths]
    poses = [_pose(800.0 + i) for i in range(len(frames))]
    det = cfg.DetectorConfig()
    want = jax_training.add_templates_batched(bgrs, depths, masks, poses,
                                              det)
    return (bgrs, depths, masks, poses), det, want


def test_pan_chunk_views_match_jax(host_path, pan_chunk):
    """The panned chunk's views, batched, equal JAX's batched views."""
    (bgrs, depths, masks, poses), det, want = pan_chunk
    got = training.add_templates_batched(bgrs, depths, masks, poses,
                                         to_port(det), device="cpu",
                                         workers=2)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_same_view(g, w)


def test_random_masks_batched_views_match_jax(host_path):
    """Views with random masks (rectangles with holes, one touching the
    frame's corner) equal JAX's batched views."""
    rng = np.random.default_rng(17)
    det = cfg.DetectorConfig(image_width=W, image_height=H)
    bgr, depth, _ = make_scene(np.random.default_rng(7))
    masks = []
    for k in range(4):
        m = np.zeros((H, W), bool)
        y0, x0 = (0, 0) if k == 0 else (int(rng.integers(0, H // 2)),
                                         int(rng.integers(0, W // 2)))
        m[y0:y0 + int(rng.integers(40, H // 2)),
          x0:x0 + int(rng.integers(40, W // 2))] = True
        m &= rng.random((H, W)) < 0.97
        masks.append(m)
    poses = [_pose(600.0 + k) for k in range(4)]
    args = ([bgr] * 4, [depth] * 4, masks, poses)
    want = jax_training.add_templates_batched(*args, det)
    got = training.add_templates_batched(*args, to_port(det), device="cpu",
                                         workers=2)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert_same_view(g, w)


class _Launches(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the operators that are not views: each launches one kernel
    on a card."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.n += 1
        return func(*args, **(kwargs or {}))


def _launches(fn):
    with _Launches() as c:
        out = fn()
    return c.n, out


def _per_crop_levels(bgr, depth, det):
    """The serving front-end (one (H, W[, 3]) image per call) on one crop:
    per level (angle bits, magnitude, normal bits)."""
    cg, dn = det.color_gradient, det.depth_normal
    src = torch.from_numpy(bgr)
    qdn = q.quantize_normals(torch.from_numpy(depth.astype(np.int32)),
                             dn.distance_threshold, dn.difference_threshold)
    out = []
    for l in range(det.pyramid_levels):
        if l > 0:
            src = fi.pyr_down_u8(src)
            qdn = qdn[::2, ::2]
        ab, mag = q.quantize_gradients(src, cg.weak_threshold)
        out.append((ab, mag, qdn))
    return out


@pytest.mark.parametrize("det", [
    cfg.DetectorConfig(image_width=W, image_height=H),
    cfg.DetectorConfig(t_at_level=(5, 8, 4))], ids=["two_levels",
                                                    "three_levels"])
def test_quantize_crops_batched_equals_per_crop(det):
    """Batched ``quantize_crops`` equals quantize_gradients / pyr_down_u8
    / quantize_normals run crop by crop, at every level and for all three
    outputs (magnitudes compared as bits), and launches the same number
    of operators for 1 crop and for 4."""
    bgrs, depths, masks = (list(a) for a in zip(*_views(4)))
    det = to_port(det)
    _, bgr_c, dep_c, _ = training.crop_views(bgrs, depths, masks,
                                             det.pyramid_levels)
    n4, got = _launches(lambda: training.quantize_crops(bgr_c, dep_c, det,
                                                        "cpu"))
    n1, _ = _launches(lambda: training.quantize_crops(bgr_c[:1], dep_c[:1],
                                                      det, "cpu"))
    assert n4 == n1
    assert len(got) == det.pyramid_levels
    for i in range(len(bgr_c)):
        want = _per_crop_levels(bgr_c[i], dep_c[i], det)
        for l, (ab, mag, qdn) in enumerate(want):
            g_ab, g_mag, g_qdn = got[l][i]
            assert g_ab.dtype == np.uint8 and g_qdn.dtype == np.uint8
            assert g_mag.dtype == np.float32
            np.testing.assert_array_equal(g_ab, ab.numpy())
            np.testing.assert_array_equal(g_mag.view(np.uint32),
                                          mag.numpy().view(np.uint32))
            np.testing.assert_array_equal(g_qdn, qdn.numpy())


# Operators (non-view) of each front-end function on one image, as they
# were before the functions accepted a batch: a batch must not cost the
# serving path a launch.
SINGLE_IMAGE_LAUNCHES = {
    "gaussian_blur7_u8": 40, "sobel3_i16 x": 20, "sobel3_i16 y": 20,
    "pyr_down_u8 bgr": 22, "pyr_down_u8 gray": 22, "median_blur5_u8": 171,
    "erode3_bool": 30, "quantize_gradients": 191, "quantize_normals": 378,
    "apply_mask": 2}


def _frontend_calls(img, quant, arrays, batched=False):
    """Each front-end function of the modules ``img`` and ``quant`` (the
    port's or JAX's) on ``arrays``; a batch has no gray pyr_down."""
    bgr, gray, depth, bits, mask = arrays
    calls = {
        "gaussian_blur7_u8": lambda: img.gaussian_blur7_u8(bgr),
        "sobel3_i16 x": lambda: img.sobel3_i16(bgr, "x"),
        "sobel3_i16 y": lambda: img.sobel3_i16(bgr, "y"),
        "pyr_down_u8 bgr": lambda: img.pyr_down_u8(bgr),
        "pyr_down_u8 gray": lambda: img.pyr_down_u8(gray),
        "median_blur5_u8": lambda: img.median_blur5_u8(bits),
        "erode3_bool": lambda: img.erode3_bool(mask, 2),
        "quantize_gradients": lambda: quant.quantize_gradients(bgr, 10.0),
        "quantize_normals": lambda: quant.quantize_normals(depth, 2000, 50),
        "apply_mask": lambda: quant.apply_mask(bits, mask)}
    if batched:
        del calls["pyr_down_u8 gray"]
    return calls


def _frontend_inputs(rng, lead):
    h, w = 48, 64
    depth = rng.integers(500, 900, lead + (h, w)).astype(np.int32)
    depth[..., 10:20, 30:50] += 600
    return (rng.integers(0, 256, lead + (h, w, 3), dtype=np.uint8),
            rng.integers(0, 256, lead + (h, w), dtype=np.uint8), depth,
            (1 << rng.integers(0, 8, lead + (h, w))).astype(np.uint8),
            rng.random(lead + (h, w)) < 0.8)


def _outs(out):
    return out if isinstance(out, tuple) else (out,)


def test_frontend_single_image_launches_and_values_unchanged():
    """On one (H, W[, 3]) image each front-end function launches what it
    did before it accepted a batch, and gives the JAX package's values."""
    import jax.numpy as jnp
    from fealess_tpu.ops import quantize as jax_q
    arrays = _frontend_inputs(np.random.default_rng(0), ())
    port = _frontend_calls(fi, q, [torch.from_numpy(a) for a in arrays])
    ref = _frontend_calls(jax_image, jax_q, [jnp.asarray(a) for a in arrays])
    for name, fn in port.items():
        n, out = _launches(fn)
        assert n == SINGLE_IMAGE_LAUNCHES[name], (name, n)
        for o, w in zip(_outs(out), _outs(ref[name]())):
            w = np.asarray(w)
            assert o.numpy().dtype == w.dtype, name
            np.testing.assert_array_equal(o.numpy(), w, err_msg=name)


def test_frontend_batch_axes_equal_per_image():
    """A batch of 3 images through each front-end function (colour
    filters on (N, H, W, 3), gray ones on (N, H, W)) equals the images
    one by one, bit for bit, with the launches of one image."""
    arrays = [torch.from_numpy(a)
              for a in _frontend_inputs(np.random.default_rng(4), (3,))]
    batched = _frontend_calls(fi, q, arrays, batched=True)
    for name, fn in batched.items():
        n, out = _launches(fn)
        assert n == SINGLE_IMAGE_LAUNCHES[name], (name, n)
        for i in range(3):
            one = _frontend_calls(fi, q, [a[i] for a in arrays])[name]()
            for o, w in zip(_outs(out), _outs(one)):
                assert o.dtype == w.dtype and o.shape[1:] == w.shape, name
                assert torch.equal(o[i], w), (name, i)
