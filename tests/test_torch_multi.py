"""The port's multi-object Recognition (top-M refine + 3D NMS) held against
the JAX engine's ``recognition_multi``: on the training frame (the
candidates collapse to one result), on the two-instance scene of
tests/test_multi_object.py (two results) and on an empty scene, in both
ICP modes and with forced ICP iterations.  Result count, match rects,
similarity and obj_tag are exact; poses agree to 0.05 mm and 0.01 deg
(tests/test_torch_engine.py's tolerances)."""

import numpy as np
import pytest
import torch

from fealess_tpu.engine import CamIntrinsics as JaxCam
from fealess_tpu_torch import pipeline
from fealess_tpu_torch.engine import CamIntrinsics
from tests.test_match_e2e import H, W
from tests.test_multi_object import _two_instance_scene
from tests.test_torch_engine import (CX, CY, FX, FY, _engines,  # noqa: F401
                                     _same_results, feature_dir)

torch.set_num_threads(1)

JCAM = JaxCam(FX, FY, CX, CY, W, H)
PCAM = CamIntrinsics(FX, FY, CX, CY, W, H)


def _scenes(feature_dir):  # noqa: F811
    bgr, depth, _ = feature_dir[1]
    two_bgr, two_depth, _ = _two_instance_scene(np.random.default_rng(3),
                                                bgr, depth)
    blank = (np.full((H, W, 3), 40, np.uint8), np.full((H, W), 1200,
                                                       np.uint16))
    return {"training": (bgr, depth, 1), "two": (two_bgr, two_depth, 2),
            "empty": (*blank, 0)}


@pytest.mark.parametrize("mode", ["point_to_plane", "point_to_point"])
def test_recognition_multi_matches_jax(feature_dir, mode):  # noqa: F811
    ref, port = _engines(feature_dir, mode)
    for name, (bgr, depth, count) in _scenes(feature_dir).items():
        want = ref.recognition_multi(bgr, depth, JCAM, max_objects=4)
        got = port.recognition_multi(bgr, depth, PCAM, max_objects=4)
        assert len(got) == count, name
        _same_results(got, want)


def test_recognition_multi_forced_icp_matches_jax(feature_dir):  # noqa: F811
    """Forced ICP iterations through the advanced parameters, with the
    engine's own max_objects (set there too, 8 candidates); an ROI mask
    that covers one instance leaves one result."""
    ref, port = _engines(feature_dir, "point_to_plane")
    for eng in (ref, port):
        eng.set_advanced_param("icp_dist_mean_threshold", 0.0)
        eng.set_advanced_param("icp_dist_diff_threshold", -1e30)
        eng.set_advanced_param("max_objects", 8)
    bgr, depth, _ = _scenes(feature_dir)["two"]
    _same_results(port.recognition_multi(bgr, depth, PCAM),
                  ref.recognition_multi(bgr, depth, JCAM))
    roi = np.zeros((H, W), bool)
    roi[:80, :120] = True
    got = port.recognition_multi(bgr, depth, PCAM, roi_mask=roi,
                                 class_ids=["obj"])
    _same_results(got, ref.recognition_multi(bgr, depth, JCAM, roi_mask=roi,
                                             class_ids=["obj"]))
    assert len(got) == 1


def test_recognize_multi_step_fields(feature_dir):  # noqa: F811
    """The step refines every one of the top-M candidates (invalid ones
    too, as the JAX map does) and takes each live slot's fields from its
    NMS winner."""
    _, port = _engines(feature_dir, "point_to_point")
    bgr, depth, _ = _scenes(feature_dir)["two"]
    bgr_d, depth_d, k = port._prepare_frame(bgr, depth, PCAM)
    step = pipeline.recognize_multi(port.bank, port._model_depth_dev,
                                    port._origins_dev, bgr_d, depth_d, k,
                                    port.cfg, 4, kernels=port._kernels)
    assert step.poses.shape == (4, 4, 4) and step.valid.shape == (4,)
    assert int(step.valid.sum()) == 2
    live = step.valid.nonzero()[:, 0]
    xs = sorted(int(v) for v in step.match_x[live])
    assert xs[1] - xs[0] > 50          # the two pasted instances
    assert bool((step.n_pairs[live] > 0).all())


def test_nms_advanced_params_round_trip():
    from fealess_tpu_torch.engine import ObjReco
    eng = ObjReco.create("LmICP", device="cpu")
    assert eng.get_advanced_param("max_objects") == eng.cfg.max_objects
    eng.set_advanced_param("max_objects", 3)
    eng.set_advanced_param("nms_object_distance", 25.0)
    assert eng.get_advanced_param("max_objects") == 3
    assert eng.get_advanced_param("nms_object_distance") == 25.0
    assert (eng.cfg.max_objects, eng.cfg.nms_object_distance) == (3, 25.0)
