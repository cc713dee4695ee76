"""``ObjReco.compute_pose_epnp`` and ``geometry/pnp.py`` against the JAX
package's ``compute_pose_epnp`` (cv2.solvePnP with SOLVEPNP_EPNP, then
cv2.Rodrigues): JAX's planar case, the fixture's model depth at a known
pose and at its match offset, 24 seeded non-planar depth maps (smooth
surfaces with noise) at random poses and offsets, and the fewer-than-4
points case.  Poses agree within 1e-3 deg and 1e-3 mm (measured: ~1e-11);
None exactly where JAX returns None.  ``solve_pnp_epnp`` and
``rodrigues`` are also held to cv2 directly, the latter on its branches
(identity, near pi, general)."""

import os

import cv2
import numpy as np
import pytest
import torch

from fealess_tpu.engine import CamIntrinsics as JaxCam
from fealess_tpu.engine import ObjReco as JaxReco
from fealess_tpu_torch.engine import CamIntrinsics, ObjReco
from fealess_tpu_torch.geometry import pnp

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks", "reference", "out")
ROT_TOL_DEG = 1e-3
T_TOL_MM = 1e-3


def _rot_diff_deg(r1, r2):
    d = np.asarray(r1, np.float64).T @ np.asarray(r2, np.float64)
    skew = np.array([d[2, 1] - d[1, 2], d[0, 2] - d[2, 0],
                     d[1, 0] - d[0, 1]]) / 2
    return np.degrees(np.arcsin(min(1.0, np.linalg.norm(skew))))


@pytest.fixture(scope="module")
def engines():
    return JaxReco.create("LmICP"), ObjReco.create("LmICP", device="cpu")


def _both(engines, raw, mx, my, pose, cam):
    jax_eng, port_eng = engines
    want = jax_eng.compute_pose_epnp(raw, mx, my, pose, JaxCam(
        cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height))
    got = port_eng.compute_pose_epnp(raw, mx, my, pose, cam)
    return got, want


def _same_pose(got, want):
    assert got is not None and want is not None
    assert got.dtype == np.float32 and got.shape == (4, 4)
    np.testing.assert_array_equal(got[3], want[3])
    assert _rot_diff_deg(got[:3, :3], want[:3, :3]) <= ROT_TOL_DEG
    np.testing.assert_allclose(got[:3, 3], want[:3, 3], atol=T_TOL_MM,
                               rtol=0)


def test_epnp_planar_case_matches_jax(engines):
    """JAX's own case (tests/test_misc_parity.py): a tilted plane in a box,
    identity pose; JAX holds it to the identity within 1e-2 on R and 5 mm
    on t, the port is held to JAX within 1e-3 deg / 1e-3 mm."""
    cam = CamIntrinsics(fx=608.0, fy=608.0, cx=120.0, cy=80.0, width=240,
                        height=160)
    raw = np.full((160, 240), 12000, np.uint16)
    yy, xx = np.mgrid[40:120, 60:180]
    raw[40:120, 60:180] = (7000 + 4 * (xx - 60) + 2 * (yy - 40)).astype(
        np.uint16)
    got, want = _both(engines, raw, 0, 0, np.eye(4, dtype=np.float32), cam)
    _same_pose(got, want)
    np.testing.assert_allclose(got[:3, :3], np.eye(3), atol=1e-2)
    assert np.linalg.norm(got[:3, 3]) < 5.0


def _fixture_cam():
    with open(os.path.join(FIXTURE, "cam.txt")) as f:
        fx, fy, cx, cy = (float(v) for v in f.read().split())
    return CamIntrinsics(fx, fy, cx, cy, 640, 480)


@pytest.mark.parametrize("case", ["known_pose", "match_offset"])
def test_epnp_fixture_depth_matches_jax(engines, case):
    """The fixture's model depth ``features/depth/0.png`` (30720 masked
    pixels): at R = 0.3 rad about y, t = (0, 0, 700) with no offset (the
    pose comes back), and from the identity at 700 mm with the fixture's
    match offset (237, 157) (a definite non-trivial pose)."""
    raw = cv2.imread(os.path.join(FIXTURE, "features", "depth", "0.png"),
                     cv2.IMREAD_UNCHANGED)
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = 700.0
    offset = (237, 157)
    if case == "known_pose":
        c, s = np.cos(0.3), np.sin(0.3)
        pose[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        offset = (0, 0)
    got, want = _both(engines, raw, *offset, pose, _fixture_cam())
    _same_pose(got, want)
    if case == "known_pose":
        np.testing.assert_allclose(got, pose, atol=1e-3)
    else:
        np.testing.assert_allclose(got[:3, 3], (273.931, 179.652, 717.913),
                                   atol=0.01)


def _surface(rng, h, w):
    """A smooth random depth surface (0.1 mm) with noise inside an
    ellipse; background at the sentinel 12000."""
    yy, xx = np.mgrid[0:h, 0:w]
    a = rng.uniform(-1, 1, 6)
    surf = 6000 + 800 * (a[0] * np.sin(xx / 20 * a[1])
                         + a[2] * np.cos(yy / 15 * a[3])
                         + a[4] * (xx / w) ** 2 + a[5] * (yy / h) * (xx / w))
    surf += rng.normal(0, 20, surf.shape)
    raw = np.full((h, w), 12000, np.uint16)
    inside = ((xx - w / 2) ** 2 / (0.38 * w) ** 2
              + (yy - h / 2) ** 2 / (0.38 * h) ** 2) < 1
    raw[inside] = np.clip(surf[inside], 200, 11000).astype(np.uint16)
    return raw


@pytest.mark.parametrize("seed", range(24))
def test_epnp_random_surfaces_match_jax(engines, seed):
    rng = np.random.default_rng(1000 + seed)
    h, w = (120, 160) if seed % 2 else (96, 128)
    raw = _surface(rng, h, w)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = cv2.Rodrigues(rng.normal(0, 0.3, 3))[0]
    pose[:3, 3] = rng.uniform(-50, 50, 3) + (0, 0, 650)
    cam = CamIntrinsics(float(rng.uniform(400, 700)),
                        float(rng.uniform(400, 700)), w / 2 + 3.5,
                        h / 2 - 2.25, w, h)
    mx, my = (int(v) for v in rng.integers(-40, 80, 2))
    got, want = _both(engines, raw, mx, my, pose, cam)
    _same_pose(got, want)


def test_epnp_too_few_points_is_none(engines):
    """Three pixels below the sentinel, or four of which one is under the
    10 mm gate: None from both."""
    cam = CamIntrinsics(608.0, 608.0, 16.0, 12.0, 32, 24)
    for depths in ((7000, 7100, 7200), (7000, 7100, 7200, 50)):
        raw = np.full((24, 32), 12000, np.uint16)
        for i, d in enumerate(depths):
            raw[5 + i, 7 + 2 * i] = d
        got, want = _both(engines, raw, 3, 4, np.eye(4, dtype=np.float32),
                          cam)
        assert got is None and want is None
    raw[20, 20] = 7300
    got, want = _both(engines, raw, 3, 4, np.eye(4, dtype=np.float32), cam)
    assert got is not None and want is not None


@pytest.mark.parametrize("n,dtype", [(6, np.float32), (7, np.float64),
                                     (9, np.float32), (200, np.float64)])
def test_solve_pnp_epnp_matches_cv2(n, dtype):
    """Random noisy correspondences in front of a camera, both float32 and
    float64 points: the same rvec and tvec as cv2.solvePnP (EPnP).  From 6
    points on, M^T M has a one-dimensional null space; below, it has an
    exact null space of dimension 12 - 2n, and the basis an SVD returns
    for it is its own rounding (see ``geometry/pnp.py``)."""
    rng = np.random.default_rng(n)
    k = np.array([[520.0, 0, 311.5], [0, 530.0, 245.25], [0, 0, 1]])
    for _ in range(10):
        obj = rng.uniform(-80, 80, (n, 3)).astype(dtype)
        r = cv2.Rodrigues(rng.normal(0, 0.5, 3))[0]
        t = np.array([rng.uniform(-40, 40), rng.uniform(-40, 40),
                      rng.uniform(500, 900)])
        cam = obj.astype(np.float64) @ r.T + t
        img = (cam[:, :2] / cam[:, 2:] * [520.0, 530.0] + [311.5, 245.25]
               + rng.normal(0, 1.0, (n, 2))).astype(dtype)
        _, rv_want, tv_want = cv2.solvePnP(obj, img, k, None,
                                           flags=cv2.SOLVEPNP_EPNP)
        ok, rv, tv = pnp.solve_pnp_epnp(obj, img, k)
        assert ok and rv.shape == tv.shape == (3, 1)
        assert _rot_diff_deg(cv2.Rodrigues(rv_want)[0],
                             pnp.rodrigues(rv)) <= ROT_TOL_DEG
        np.testing.assert_allclose(tv, tv_want, atol=T_TOL_MM, rtol=0)


def test_rodrigues_matches_cv2():
    rng = np.random.default_rng(7)
    vecs = [np.zeros(3), np.array([1e-9, 0, 0]), np.array([np.pi, 0, 0]),
            np.array([0, -np.pi + 1e-7, 0]),
            np.array([1.0, 2.0, -2.0]) / 3 * (np.pi - 1e-6)]
    vecs += [rng.normal(0, 1.0, 3) for _ in range(50)]
    for v in vecs:
        want_r = cv2.Rodrigues(v.reshape(3, 1))[0]
        np.testing.assert_allclose(pnp.rodrigues(v), want_r, atol=1e-12,
                                   rtol=0)
        # near pi the vector is ill-conditioned in R: the SVDs that
        # re-orthonormalize R round differently by ~1e-9 rad
        want_v = cv2.Rodrigues(want_r)[0]
        np.testing.assert_allclose(pnp.rodrigues(want_r), want_v,
                                   atol=1e-8, rtol=0)
    with pytest.raises(ValueError):
        pnp.rodrigues(np.eye(4))
    with pytest.raises(ValueError):
        pnp.epnp_pose(np.zeros((3, 3)), np.zeros((3, 2)), np.eye(3))
