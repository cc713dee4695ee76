"""The port's own copies of JAX-package helpers against the originals:
``ops/luts.ORIENTATION_SCORES``, ``apps/metrics`` (ADD and pose errors),
``apps/model_mesh.load_obj`` and ``utils/profiling.StageTimer`` give the
same values on the same inputs, made from a seed; ``io/native`` loads a
library by path and refuses to run a binding without one."""

import numpy as np
import pytest

from fealess_tpu.apps import metrics as jax_metrics
from fealess_tpu.apps import model_mesh as jax_mesh
from fealess_tpu.ops import luts as jax_luts
from fealess_tpu.utils import profiling as jax_profiling
from fealess_tpu_torch.apps import metrics, model_mesh
from fealess_tpu_torch.io import native
from fealess_tpu_torch.ops import luts
from fealess_tpu_torch.utils import profiling


def _pose(rng, deg):
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    th = np.radians(deg)
    p = np.eye(4, dtype=np.float32)
    p[:3, :3] = np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k
    p[:3, 3] = rng.normal(size=3) * 20 + [0, 0, 700]
    return p


def test_orientation_scores_match_jax():
    assert luts.ORIENTATION_SCORES == jax_luts.ORIENTATION_SCORES


@pytest.mark.parametrize("n_points", [50, 3000])
def test_metrics_match_jax(n_points):
    """ADD, rotation and translation errors and the summary over a series
    with a missed frame; the exact and the bounding-box diameter."""
    rng = np.random.default_rng(n_points)
    pts = (rng.normal(size=(n_points, 3)) * 30).astype(np.float32)
    gt = [_pose(rng, 10.0) for _ in range(5)]
    est = [g.copy() for g in gt]
    for i, e in enumerate(est):
        e[:3, 3] += rng.normal(size=3) * i
    est[2] = None
    got = metrics.evaluate(est, gt, pts, add_tau=0.1)
    want = jax_metrics.evaluate(est, gt, pts, add_tau=0.1)
    for f in ("n_frames", "n_detected", "add_pass_rate", "detection_rate",
              "mean_add", "mean_rot_deg", "mean_trans_mm"):
        assert getattr(got, f) == getattr(want, f), f
    for g, w in zip(got.errors, want.errors):
        assert (g is None) == (w is None)
        if g is not None:
            assert (g.add, g.rot_deg, g.trans_mm) == \
                (w.add, w.rot_deg, w.trans_mm)
    assert metrics.model_diameter(pts) == jax_metrics.model_diameter(pts)


def test_load_obj_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    path = tmp_path / "m.obj"
    lines = [f"v {a} {b} {c}" for a, b, c in rng.normal(size=(9, 3)) * 40]
    lines += [f"vt {a} {b}" for a, b in rng.random((4, 2))]
    lines += ["vn 0 0 1", "f 1/1/1 2/2/1 3/3/1", "f 4 5 6", "", "# c",
              "f 7 8 9"]
    path.write_text("\n".join(lines) + "\n")
    got = model_mesh.load_obj(str(path), model_scale=0.1)
    want = jax_mesh.load_obj(str(path), model_scale=0.1)
    for f in ("vertices", "faces", "texcoords", "normals"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def test_stage_timer_report_matches_jax():
    got, want = profiling.StageTimer(), jax_profiling.StageTimer()
    for timer in (got, want):
        for name, s in (("decode", 0.002), ("match", 0.0125),
                        ("decode", 0.004)):
            timer.add(name, s)
    assert got.report() == want.report()


def test_native_bindings_need_a_library(monkeypatch, tmp_path):
    """Without a library every binding raises (callers check
    have_native() first); a path that is not a library raises too."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_SEARCHED", True)
    assert not native.have_native()
    with pytest.raises(RuntimeError, match="have_native"):
        native.chamfer_chessboard(np.ones((4, 4), bool))
    bogus = tmp_path / "libnot.so"
    bogus.write_bytes(b"not a library")
    with pytest.raises(OSError):
        native.load_library(bogus)
