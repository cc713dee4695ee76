"""The port's KCF-gated recognizers held against the JAX package's over a
panned synthetic sequence: ``TrackedRecognizer`` on the training frame
(including two frames of background only, which lose the object, and a
re-detection) and
``MultiTrackedRecognizer`` on the two-instance scene of
tests/test_multi_object.py.  The redetected flags, tracked counts, result
counts, match rects and similarities are equal; ROIs agree to 0.05 px
(tests/test_torch_tracker.py's tracker tolerance) and poses to 0.05 mm /
0.01 deg (tests/test_torch_engine.py's), ICP's mean distance to 1e-3 mm:
on frames 2-3 of this pan the poses part by 3e-4 mm after ICP's
iterations, and the mean distance by 7.6e-5 mm (1.5e-4 relative).

The scene is make_scene's with the object's green channel at 3/4 of the
blue one's complement.  In make_scene itself green is the exact
complement, so FHOG's strongest-channel choice is an exact tie at every
object pixel, decided by the last bit of the resampled patch; the jitted
JAX tracker recomputes that patch inside its FHOG fusion with other
roundings than it stores, which no port can follow (ROIs then part by
0.1 px within a frame and a scale step within three)."""

import numpy as np
import pytest
import torch

from fealess_tpu.apps import track as jax_track
from fealess_tpu.engine import CamIntrinsics as JaxCam
from fealess_tpu_torch.apps import track
from fealess_tpu_torch.engine import CamIntrinsics
from tests.test_match_e2e import H, W, make_scene
from tests.test_multi_object import _two_instance_scene
from tests.test_torch_engine import (CX, CY, FX, FY, _engines, _same_results,
                                     write_feature_dir)

torch.set_num_threads(1)

ROI_TOL_PX = 0.05
DIST_ATOL_MM = 1e-3
JCAM = JaxCam(FX, FY, CX, CY, W, H)
PCAM = CamIntrinsics(FX, FY, CX, CY, W, H)


@pytest.fixture(scope="module")
def track_dir(tmp_path_factory):
    bgr, depth, mask = make_scene(np.random.default_rng(7))
    bgr[mask, 1] = (255 - bgr[mask, 0].astype(np.int32)) * 3 // 4
    return write_feature_dir(tmp_path_factory.mktemp("track"), bgr, depth,
                             mask)


def _pan(bgr, depth, n):
    return [(np.roll(np.roll(bgr, i, 0), 2 * i, 1),
             np.roll(np.roll(depth, i, 0), 2 * i, 1)) for i in range(n)]


def _same_rois(got, want):
    assert (got is None) == (want is None)
    if got is not None:
        np.testing.assert_allclose(got, want, atol=ROI_TOL_PX, rtol=0)


def test_tracked_recognizer_matches_jax(track_dir):
    ref, port = _engines(track_dir, "point_to_plane")
    bgr, depth, _ = track_dir[1]
    # the background without the object (a uniform frame would give the
    # tracker a flat response, whose argmax is rounding noise)
    empty = np.full((H, W, 3), 40, np.uint8) + np.random.default_rng(
        11).integers(0, 12, (H, W, 3), dtype=np.uint8)
    gone = (empty, np.full((H, W), 1200, np.uint16))
    frames = _pan(bgr, depth, 4) + [gone, gone] + _pan(bgr, depth, 6)[5:]
    jt, pt = jax_track.TrackedRecognizer(ref), track.TrackedRecognizer(port)
    flags = []
    for i, (b, d) in enumerate(frames):
        want = jt.step(b, d, JCAM)
        got = pt.step(b, d, PCAM)
        assert (got.redetected, got.tracking) == (want.redetected,
                                                  want.tracking), i
        _same_results(got.results, want.results, DIST_ATOL_MM)
        _same_rois(got.roi, want.roi)
        flags.append((got.redetected, len(got.results)))
    # found, tracked 3 frames, lost on the background (the second frame
    # re-detects and finds nothing), found again
    assert flags == [(True, 1), (False, 1), (False, 1), (False, 1),
                     (False, 0), (True, 0), (True, 1)]


def test_multi_tracked_recognizer_matches_jax(track_dir):
    ref, port = _engines(track_dir, "point_to_point")
    bgr, depth, _ = track_dir[1]
    two_bgr, two_depth, _ = _two_instance_scene(np.random.default_rng(3),
                                                bgr, depth)
    jt = jax_track.MultiTrackedRecognizer(ref, max_objects=4)
    pt = track.MultiTrackedRecognizer(port, max_objects=4)
    for i, (b, d) in enumerate(_pan(two_bgr, two_depth, 4)):
        want = jt.step(b, d, JCAM)
        got = pt.step(b, d, PCAM)
        assert (got.redetected, got.n_tracked) == (want.redetected,
                                                   want.n_tracked), i
        assert got.redetected == (i == 0) and got.n_tracked == 2
        _same_results(got.results, want.results, DIST_ATOL_MM)
        assert len(got.rois) == len(want.rois)
        for g, w in zip(got.rois, want.rois):
            _same_rois(g, w)
    assert len(pt._trackers) == len(jt._trackers) == 1
