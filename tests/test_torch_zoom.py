"""Cameras whose width is not the processing width: the port's ``ObjReco``
resizes the frame with ``ops/resize`` (cv2's INTER_LINEAR for colour,
INTER_NEAREST for depth, bit for bit) and zooms the intrinsics, where the
JAX engine resizes with cv2 on the host (``fealess_tpu/engine.py:
323-349``).  Held tighter than the JAX package holds itself
(tests/test_engine.py:158, tests/test_wide_geometry.py): against JAX's
``ObjReco`` on the same inputs the match rect and similarity are exact,
the pose is within 0.05 mm and 0.01 deg with default ICP and within 0.1
mm and 0.01 deg with forced iterations, the prepared frame and K are equal,
and the processing dims re-pin as JAX's do."""

import os

import cv2
import numpy as np
import pytest
import torch

from fealess_tpu import config as cfg
from fealess_tpu import training
from fealess_tpu.engine import CamIntrinsics as JaxCam
from fealess_tpu.engine import ObjReco as JaxReco
from fealess_tpu.io import linemod_yaml
from fealess_tpu_torch.engine import CamIntrinsics, ObjReco
from tests.test_match_e2e import H, W
from tests.test_torch_config import to_port
from tests.test_torch_engine import (CX, CY, FX, FY, ROT_TOL_DEG,
                                     _engines, _rot_diff_deg, _same_results,
                                     feature_dir)  # noqa: F401

torch.set_num_threads(1)

FORCED_T_TOL_MM = 0.1


def _camera_frame(scene, scale, rows=None):
    """The scene as a camera ``scale`` times the processing resolution
    sees it (cv2.resize, nearest for depth, K scaled), cropped to ``rows``
    rows: (bgr, depth, (fx, fy, cx, cy, w, h))."""
    bgr, depth, _ = scene
    w, h = int(round(W * scale)), int(round(H * scale))
    big = cv2.resize(bgr, (w, h))
    big_depth = cv2.resize(depth, (w, h), interpolation=cv2.INTER_NEAREST)
    if rows is not None:
        big, big_depth, h = big[:rows].copy(), big_depth[:rows].copy(), rows
    return big, big_depth, (FX * scale, FY * scale, CX * scale, CY * scale,
                            w, h)


def _same_forced(got, want):
    """Forced ICP: match exact, t within 0.1 mm, rotation 0.01 deg."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.obj_tag, g.match_rect, g.similarity) == \
            (w.obj_tag, w.match_rect, w.similarity)
        np.testing.assert_allclose(g.world2cam[:3, 3], w.world2cam[:3, 3],
                                   atol=FORCED_T_TOL_MM, rtol=0)
        assert _rot_diff_deg(g.world2cam[:3, :3],
                             w.world2cam[:3, :3]) <= ROT_TOL_DEG


# camera scale and rows kept: an exact 2x downscale (cv2's INTER_AREA
# fast path), 1.5x, a 2x upscale on both axes, and a 16:9 crop of 1.5x
# whose resized height (135) is padded to the alignment (160)
_CAMERAS = {"2x": (2.0, None), "1.5x": (1.5, None), "half": (0.5, None),
            "16:9": (1.5, 202)}


@pytest.mark.parametrize("icp", ["default", "forced"])
@pytest.mark.parametrize("camera", sorted(_CAMERAS))
def test_zoomed_recognition_matches_jax(feature_dir,  # noqa: F811
                                        camera, icp):
    ref, port = _engines(feature_dir, "point_to_plane")
    if icp == "forced":
        for eng in (ref, port):
            eng.set_advanced_param("icp_dist_mean_threshold", 0.0)
            eng.set_advanced_param("icp_dist_diff_threshold", -1e30)
    bgr, depth, k = _camera_frame(feature_dir[1], *_CAMERAS[camera])
    want = ref.recognition(bgr, depth, JaxCam(*k))
    got = port.recognition(bgr, depth, CamIntrinsics(*k))
    assert want and want[0].similarity >= 90.0
    (_same_results if icp == "default" else _same_forced)(got, want)
    assert (port.cfg.detector.image_height, port.cfg.detector.image_width) \
        == (ref.cfg.detector.image_height, ref.cfg.detector.image_width) \
        == (H, W)


def test_zoomed_recognition_multi_matches_jax(feature_dir):  # noqa: F811
    """recognition_multi on a 2x camera frame whose depth and colour are
    not exact replicas (cv2's linear upscale of the scene)."""
    ref, port = _engines(feature_dir, "point_to_point")
    bgr, depth, k = _camera_frame(feature_dir[1], 2.0)
    want = ref.recognition_multi(bgr, depth, JaxCam(*k), max_objects=2)
    got = port.recognition_multi(bgr, depth, CamIntrinsics(*k),
                                 max_objects=2)
    assert want
    _same_results(got, want)


def test_prepare_frame_arbitrary_aspect_matches_jax(feature_dir):  # noqa: F811
    """A 480x270 camera at processing width 240 (tests/test_wide_geometry.py
    :114) on random content: the port's prepared colour, depth and K
    equal JAX's (resized to 240x135, padded to 240x160 with zero depth);
    so do a 2-D upscale (120x81 -> 240x162, padded to 240x240) and a
    camera one pixel off the processing width."""
    ref, port = _engines(feature_dir, "point_to_plane")
    rng = np.random.default_rng(3)
    for cw, ch in ((480, 270), (120, 81), (239, 160)):
        cam = (2 * FX, 2 * FY, cw / 2.0, ch / 2.0, cw, ch)
        rgb = rng.integers(0, 256, (ch, cw, 3), dtype=np.uint8)
        dep = rng.integers(0, 65536, (ch, cw), dtype=np.uint16)
        want = ref._prepare_frame(rgb, dep, JaxCam(*cam))
        got = port._prepare_frame(rgb, dep, CamIntrinsics(*cam))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(),
                                      np.asarray(want[1]).astype(np.int32))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        align = port.cfg.detector.pyramid_alignment
        assert got[0].shape[0] % align == 0 and got[0].shape[1] == W
        assert (port.cfg.detector.image_height,
                port.cfg.detector.image_width) == \
            (ref.cfg.detector.image_height, ref.cfg.detector.image_width)


def test_aspect_change_reconfigures_engine_matches_jax(  # noqa: F811
        feature_dir):
    """One engine serving the native camera, then a 260x200 canvas (zoom
    240/260, resized and padded: new processing dims), then the native
    camera again (tests/test_wide_geometry.py:133): at every step the
    results and the processing dims equal JAX's."""
    ref, port = _engines(feature_dir, "point_to_plane")
    bgr, depth, _ = feature_dir[1]
    ch, cw = 200, 260
    big_bgr = np.zeros((ch, cw, 3), np.uint8)
    big_bgr[:H, :W] = bgr
    big_depth = np.zeros((ch, cw), np.uint16)
    big_depth[:H, :W] = depth
    dims = []
    for frame_bgr, frame_depth, k in (
            (bgr, depth, (FX, FY, CX, CY, W, H)),
            (big_bgr, big_depth, (FX, FY, cw / 2.0, ch / 2.0, cw, ch)),
            (bgr, depth, (FX, FY, CX, CY, W, H))):
        want = ref.recognition(frame_bgr, frame_depth, JaxCam(*k))
        got = port.recognition(frame_bgr, frame_depth, CamIntrinsics(*k))
        _same_results(got, want)
        dims.append((port.cfg.detector.image_height,
                     port.cfg.detector.image_width))
        assert dims[-1] == (ref.cfg.detector.image_height,
                            ref.cfg.detector.image_width)
    assert dims[0] == dims[2] == (H, W) and dims[1] != dims[0]


def test_non_aligned_camera_pads_matches_jax(feature_dir):  # noqa: F811
    """A 260x180 camera at processing width 260 (zoom 1, padded to the
    alignment; tests/test_wide_geometry.py:31) equals JAX."""
    _, (bgr, depth, _) = feature_dir
    ch, cw = 180, 260
    big_bgr = np.zeros((ch, cw, 3), np.uint8)
    big_bgr[:H, :W] = bgr
    big_depth = np.zeros((ch, cw), np.uint16)
    big_depth[:H, :W] = depth
    ecfg = cfg.EngineConfig(
        detector=cfg.DetectorConfig(image_width=cw, max_candidates=16),
        template_fx=FX, template_fy=FY, template_cx=CX, template_cy=CY,
        refine_crop=128, icp=cfg.IcpConfig(max_points=4096))
    ref = JaxReco.create("LmICP", ecfg)
    ref.add_obj(feature_dir[0])
    port = ObjReco.create("LmICP", to_port(ecfg), device="cpu")
    port.add_obj(feature_dir[0])
    k = (FX, FY, cw / 2.0, ch / 2.0, cw, ch)
    want = ref.recognition(big_bgr, big_depth, JaxCam(*k))
    got = port.recognition(big_bgr, big_depth, CamIntrinsics(*k))
    assert want and want[0].similarity >= 90.0
    # the shifted principal point makes ICP iterate; its mean distance
    # agrees to 1e-3 mm (the CLI tests' bound), as one of 4096 pairs may
    # cross the inlier gate on a float32 near-tie
    _same_results(got, want, dist_atol=1e-3)
    d = port.cfg.detector
    assert (d.image_height, d.image_width) == \
        (ref.cfg.detector.image_height, ref.cfg.detector.image_width)
    assert d.image_width % d.pyramid_alignment == 0 and d.image_width >= cw


def test_wide_processing_width_matches_jax(feature_dir,  # noqa: F811
                                           tmp_path):
    """A bank trained at 4x the scale (960x640, tests/test_wide_geometry.py
    :59) served on a 4x camera at its own width and, zoomed, on a 2x camera
    (cv2's 2x linear upscale of the 2x frame to 960 wide): both equal
    JAX."""
    _, (bgr, depth, mask) = feature_dir
    s = 4
    big_bgr = cv2.resize(bgr, (s * W, s * H))
    big_depth = cv2.resize(depth, (s * W, s * H),
                           interpolation=cv2.INTER_NEAREST)
    big_mask = cv2.resize(mask.astype(np.uint8), (s * W, s * H),
                          interpolation=cv2.INTER_NEAREST).astype(bool)
    det_w = cfg.DetectorConfig(image_width=s * W, image_height=s * H,
                               max_candidates=16)
    pose = np.zeros(13, np.float32)
    pose[0] = pose[5] = pose[10] = 1.0
    pose[12] = 650.0
    view = training.add_template(big_bgr, big_depth, big_mask, pose, det_w)
    assert view is not None
    d = tmp_path / "wide_features"
    os.makedirs(d / "depth")
    linemod_yaml.save_linemod(str(d / "linemod_templates.yml"), det_w,
                              {"obj": [view]})
    cv2.imwrite(str(d / "depth" / "0.png"),
                (big_depth.astype(np.uint32) * 10).astype(np.uint16))
    ecfg = cfg.EngineConfig(
        detector=det_w, template_fx=s * FX, template_fy=s * FY,
        template_cx=s * CX, template_cy=s * CY, refine_crop=256,
        icp=cfg.IcpConfig(max_points=4096))
    ref = JaxReco.create("LmICP", ecfg)
    ref.add_obj(str(d))
    port = ObjReco.create("LmICP", to_port(ecfg), device="cpu")
    port.add_obj(str(d))
    half_bgr = cv2.resize(bgr, (2 * W, 2 * H))
    half_depth = cv2.resize(depth, (2 * W, 2 * H),
                            interpolation=cv2.INTER_NEAREST)
    for frame_bgr, frame_depth, f in ((big_bgr, big_depth, s),
                                      (half_bgr, half_depth, 2)):
        k = (f * FX, f * FY, f * CX, f * CY, f * W, f * H)
        want = ref.recognition(frame_bgr, frame_depth, JaxCam(*k))
        got = port.recognition(frame_bgr, frame_depth, CamIntrinsics(*k))
        assert want and want[0].similarity >= 90.0
        _same_results(got, want)
