"""The port's Recognition slice end to end against the JAX engine: both
``ObjReco``s ``add_obj`` the same trained feature directory (a synthetic
160x240 RGB-D view trained by the JAX package, as tests/test_engine.py
builds it) and run ``recognition`` on the training frame and on a shifted
frame, in both ICP modes.  Match rect and similarity are exact; poses
agree to 0.05 mm and 0.01 deg (the ICP tolerance of
tests/test_torch_icp.py)."""

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
from fealess_tpu_torch.bank import bank_from_numpy
from fealess_tpu_torch.engine import CamIntrinsics, ObjReco
from tests.test_match_e2e import H, W, make_scene

torch.set_num_threads(1)

FX = FY = 608.0
CX, CY = W / 2.0, H / 2.0
T_TOL_MM = 0.05
ROT_TOL_DEG = 0.01
_LEAVES = ("feat_x", "feat_y", "feat_label", "feat_valid", "width", "height",
           "offset_x", "offset_y", "pose", "class_idx", "template_idx",
           "valid")


def write_feature_dir(d, bgr, depth, mask):
    """Train one view of a synthetic scene with the JAX package and write
    the reference artifact layout to ``d``: linemod_templates.yml +
    depth/0.png (0.1 mm units)."""
    det_cfg = cfg.DetectorConfig(image_width=W, image_height=H,
                                 max_candidates=16)
    pose = np.zeros(13, np.float32)
    pose[0] = pose[5] = pose[10] = 1.0
    pose[12] = 650.0
    view = training.add_template(bgr, depth, mask, pose, det_cfg)
    assert view is not None
    linemod_yaml.save_linemod(str(d / "linemod_templates.yml"), det_cfg,
                              {"obj": [view]})
    os.makedirs(d / "depth", exist_ok=True)
    cv2.imwrite(str(d / "depth" / "0.png"),
                (depth.astype(np.uint32) * 10).astype(np.uint16))
    return str(d), (bgr, depth, mask)


@pytest.fixture(scope="module")
def feature_dir(tmp_path_factory):
    rng = np.random.default_rng(7)
    return write_feature_dir(tmp_path_factory.mktemp("features"),
                             *make_scene(rng))


def _config(mode, **icp):
    # max_points 4096 (of the 128x128 crop) keeps the CPU twin of the NN
    # kernel quick and runs the pair compaction
    return cfg.EngineConfig(
        detector=cfg.DetectorConfig(image_width=W, image_height=H,
                                    max_candidates=16),
        template_fx=FX, template_fy=FY, template_cx=CX, template_cy=CY,
        refine_crop=128,
        icp=cfg.IcpConfig(mode=mode, max_points=4096, **icp))


def _engines(feature_dir, mode, **icp):
    path = feature_dir[0]
    ref = JaxReco.create("LmICP", _config(mode, **icp))
    ref.add_obj(path)
    port = ObjReco.create("LmICP", _config(mode, **icp), device="cpu")
    port.add_obj(path)
    return ref, port


def _rot_diff_deg(r1, r2):
    m = np.asarray(r1, np.float64).T @ np.asarray(r2, np.float64)
    w = 0.5 * np.array([m[2, 1] - m[1, 2], m[0, 2] - m[2, 0],
                        m[1, 0] - m[0, 1]])
    return float(np.degrees(np.arcsin(min(np.linalg.norm(w), 1.0))))


def _same_results(got, want, dist_atol=0.0):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.obj_tag == w.obj_tag
        assert g.match_rect == w.match_rect
        assert g.similarity == w.similarity
        np.testing.assert_allclose(g.world2cam[:3, 3], w.world2cam[:3, 3],
                                   atol=T_TOL_MM, rtol=0)
        assert _rot_diff_deg(g.world2cam[:3, :3],
                             w.world2cam[:3, :3]) <= ROT_TOL_DEG
        np.testing.assert_array_equal(g.world2cam[3], [0, 0, 0, 1])
        np.testing.assert_allclose(g.icp_dist, w.icp_dist, rtol=1e-4,
                                   atol=dist_atol)
        np.testing.assert_allclose(g.inlier_ratio, w.inlier_ratio, atol=2e-3)


def _frames(scene):
    bgr, depth, _ = scene
    dx, dy = 16, 8
    shifted = (np.roll(np.roll(bgr, dy, 0), dx, 1),
               np.roll(np.roll(depth, dy, 0), dx, 1))
    return [(bgr, depth), shifted]


@pytest.mark.parametrize("mode", ["point_to_plane", "point_to_point"])
def test_recognition_matches_jax(feature_dir, mode):
    ref, port = _engines(feature_dir, mode)
    for bgr, depth in _frames(feature_dir[1]):
        want = ref.recognition(bgr, depth, JaxCam(FX, FY, CX, CY, W, H))
        got = port.recognition(bgr, depth, CamIntrinsics(FX, FY, CX, CY, W, H))
        assert len(got) == 1 and got[0].similarity >= 95.0
        _same_results(got, want)


def test_recognition_forced_iterations_matches_jax(feature_dir):
    """Forced ICP iterations set through the advanced parameters, as on
    the card; a frame 150 rows tall is padded to the pyramid alignment."""
    ref, port = _engines(feature_dir, "point_to_plane")
    for eng in (ref, port):
        eng.set_advanced_param("icp_dist_mean_threshold", 0.0)
        eng.set_advanced_param("icp_dist_diff_threshold", -1e30)
    assert port.get_advanced_param("icp_dist_diff_threshold") == -1e30
    bgr, depth = _frames(feature_dir[1])[1]
    bgr, depth = bgr[:150], depth[:150]
    want = ref.recognition(bgr, depth, JaxCam(FX, FY, CX, CY, W, 150))
    got = port.recognition(bgr, depth, CamIntrinsics(FX, FY, CX, CY, W, 150))
    assert (port.cfg.detector.image_height,
            port.cfg.detector.image_width) == (160, 240)
    _same_results(got, want)


def test_recognition_gates_match_jax(feature_dir):
    """roi_mask and class_ids reach the detector's gates as in JAX; an ROI
    away from the object and a blank scene find nothing."""
    ref, port = _engines(feature_dir, "point_to_point")
    bgr, depth, mask = feature_dir[1]
    jcam, pcam = JaxCam(FX, FY, CX, CY, W, H), CamIntrinsics(FX, FY, CX, CY,
                                                             W, H)
    away = np.zeros((H, W), bool)
    away[:20, :20] = True
    for roi in (mask, away):
        _same_results(port.recognition(bgr, depth, pcam, roi_mask=roi,
                                       class_ids=["obj"]),
                      ref.recognition(bgr, depth, jcam, roi_mask=roi,
                                      class_ids=["obj"]))
    assert port.recognition(bgr, depth, pcam, roi_mask=away) == []
    with pytest.raises(KeyError):
        port.recognition(bgr, depth, pcam, class_ids=["nope"])
    blank = (np.full((H, W, 3), 40, np.uint8), np.full((H, W), 1200,
                                                       np.uint16))
    assert port.recognition(*blank, pcam) == []
    assert ref.recognition(*blank, jcam) == []


def test_unported_advanced_params_are_refused():
    """Names the engine does not know raise instead of being silent no-ops;
    the JAX engine's set (multi-object's max_objects and
    nms_object_distance included) is accepted."""
    eng = ObjReco.create("LmICP", device="cpu")
    assert set(ObjReco._PARAM_PATHS) == set(JaxReco._PARAM_PATHS)
    for name in ("no_such_param", "refine_crop"):
        with pytest.raises(KeyError):
            eng.set_advanced_param(name, 2)
    eng.set_advanced_param("icp_iterations", 7)
    assert eng.get_advanced_param("icp_iterations") == 7


def test_add_obj_state_matches_jax(feature_dir):
    """The port's own add_obj builds the JAX engine's bank (and
    bank_from_numpy of the JAX leaves gives the same tensors), model depth
    stack and crop origins; other processing widths are refused."""
    ref, port = _engines(feature_dir, "point_to_plane")
    from_jax = bank_from_numpy(
        {k: np.asarray(getattr(ref.bank, k)) for k in _LEAVES},
        ref.bank.class_names, ref.bank.max_span)
    for bank in (port.bank, from_jax):
        assert bank.class_names == ref.bank.class_names
        assert bank.max_span == ref.bank.max_span
        for k in _LEAVES:
            np.testing.assert_array_equal(getattr(bank, k).numpy(),
                                          np.asarray(getattr(ref.bank, k)),
                                          err_msg=k)
    np.testing.assert_array_equal(port._model_depth_dev.numpy(),
                                  ref._model_depth.astype(np.int32))
    np.testing.assert_array_equal(port._origins_dev.numpy(),
                                  ref._origins_array())
    bgr, depth, _ = feature_dir[1]
    half = CamIntrinsics(FX / 2, FY / 2, CX / 2, CY / 2, W // 2, H // 2)
    with pytest.raises(NotImplementedError):
        port.recognition(bgr[::2, ::2].copy(), depth[::2, ::2].copy(), half)
