"""The port's geometry, nearest neighbour and ICP held against the JAX
package: the NN twin (kernel K3's contract) with planted exact ties and
PAD_COORD rows, both ICP modes on seeded clouds (a non-planar one that
takes the point-to-plane Gauss-Newton branch, a planar one that takes the
Kabsch branch), and the refine glue (crop back-projection, normals,
paired clouds).

Tolerances: integer outcomes (NN indices, iteration counts) are equal;
NN d2 agrees to 2e-7 relative, because JAX sums the three squares with
jnp.sum; ICP poses agree to 0.05 mm and 0.01 deg and dist_mean to 1e-4
relative — float32 reductions and the 3x3 SVD differ in summation order
and LAPACK path, far inside the TPU-vs-CPU spread on record for the JAX
package itself (TPUPARITY_r05.json: 1.08 mm ADD)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fealess_tpu import config as cfg
from fealess_tpu import icp as jax_icp
from fealess_tpu import pipeline as jax_pipe
from fealess_tpu.geometry import depth as jax_depth
from fealess_tpu.geometry import transforms as jax_tf
from fealess_tpu.ops import nn_pallas
from fealess_tpu_torch import icp as port_icp
from fealess_tpu_torch import pipeline as port_pipe
from fealess_tpu_torch.geometry import depth as port_depth
from fealess_tpu_torch.geometry import transforms as port_tf
from fealess_tpu_torch.ops import nn

torch.set_num_threads(1)

T_TOL_MM = 0.05
ROT_TOL_DEG = 0.01
DIST_RTOL = 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rot(axis, deg):
    axis = np.asarray(axis, np.float64)
    axis /= np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    th = np.radians(deg)
    return (np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k)


def _rot_diff_deg(r1, r2):
    """Angle of r1^T r2 from its skew part (the trace form loses small
    angles to float32 rounding of the diagonal)."""
    m = np.asarray(r1, np.float64).T @ np.asarray(r2, np.float64)
    w = 0.5 * np.array([m[2, 1] - m[1, 2], m[0, 2] - m[2, 0],
                        m[1, 0] - m[0, 1]])
    return float(np.degrees(np.arcsin(min(np.linalg.norm(w), 1.0))))


def _nn_case(rng):
    ref = (rng.normal(size=(700, 3)) * [60, 40, 15] + [0, 0, 600]
           ).astype(np.float32)
    ref[350:450] = ref[100:200]              # exact duplicates -> ties
    query = np.concatenate([ref[100:200] + 0.0,          # ties at 0
                            ref[:50] + 0.25,             # near points
                            (rng.normal(size=(300, 3)) * 70
                             + [0, 0, 600]).astype(np.float32)])
    ref[650:] = jax_icp.PAD_COORD            # padded ref rows
    query[-20:] = jax_icp.PAD_COORD          # padded query rows
    return query.astype(np.float32), ref


def test_nn_twin_matches_jax_with_ties_and_padding():
    query, ref = _nn_case(np.random.default_rng(0))
    idx, d2 = nn.nearest_neighbor_plain(_t(query), _t(ref), block=128)
    j_idx, j_d2 = nn_pallas._nn_xla_blocked(jnp.asarray(query),
                                            jnp.asarray(ref))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(d2.numpy(), np.asarray(j_d2), rtol=2e-7,
                               atol=0)
    # first minimum wins on the planted ties
    assert (idx.numpy()[:100] == np.arange(100, 200)).all()
    # the TPU kernel's semantics (interpret mode) agree as well
    p_idx, p_d2 = nn_pallas.nearest_neighbor_tiled(
        jnp.asarray(query), jnp.asarray(ref), interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(p_idx))
    np.testing.assert_allclose(d2.numpy(), np.asarray(p_d2), rtol=2e-7)


def test_nn_wrapper_routes_cpu_to_twin_and_refuses_other_devices():
    query, ref = _nn_case(np.random.default_rng(1))
    got = nn.nearest_neighbor(_t(query), _t(ref))
    want = nn.nearest_neighbor_plain(_t(query), _t(ref))
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.float32
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    meta = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError):
        nn.nearest_neighbor(meta, meta)


def _cloud(rng, n):
    pts = rng.normal(size=(n, 3)).astype(np.float32) * [60, 40, 15]
    pts[:, 2] += 600
    return pts.astype(np.float32)


def _bowl(n=32):
    xs = np.linspace(-80, 80, n, dtype=np.float32)
    gx, gy = np.meshgrid(xs, xs)
    gz = 600 + 0.004 * gx ** 2 + 0.007 * gy ** 2
    pts = np.stack([gx, gy, gz], -1).reshape(-1, 3)
    nrm = np.stack([0.008 * gx, 0.014 * gy, -np.ones_like(gx)],
                   -1).reshape(-1, 3)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return pts.astype(np.float32), nrm.astype(np.float32)


def _plane(n=32):
    xs = np.linspace(-80, 80, n, dtype=np.float32)
    gx, gy = np.meshgrid(xs, xs)
    gz = 600 + 0.1 * gx
    pts = np.stack([gx, gy, gz], -1).reshape(-1, 3)
    nrm = np.broadcast_to(np.array([0.1, 0.0, -1.0]) / np.sqrt(1.01),
                          pts.shape)
    return pts.astype(np.float32), nrm.astype(np.float32)


def _pair(rng, ref, deg, shift, cap):
    """Model cloud = ref moved by a small rigid motion plus noise, padded
    to ``cap`` rows with a few invalid pairs."""
    r = _rot([0.3, -0.5, 1.0], deg)
    center = ref.mean(0)
    model = ((ref - center) @ r.T + center + shift
             + rng.normal(size=ref.shape) * 0.5).astype(np.float32)
    mask = np.ones(len(ref), bool)
    mask[::17] = False
    pr, m = jax_icp.pad_cloud(ref, mask, cap)
    pm, _ = jax_icp.pad_cloud(model, mask, cap)
    return pr, pm, m


def _icp_equal(port, ref):
    assert bool(port.ok) == bool(ref.ok)
    assert int(port.iterations) == int(ref.iterations)
    assert port.iterations.dtype == torch.int32
    np.testing.assert_allclose(port.t.numpy(), np.asarray(ref.t),
                               atol=T_TOL_MM, rtol=0)
    assert _rot_diff_deg(port.r.numpy(), np.asarray(ref.r)) <= ROT_TOL_DEG
    np.testing.assert_allclose(float(port.dist_mean), float(ref.dist_mean),
                               rtol=DIST_RTOL)
    np.testing.assert_allclose(float(port.inlier_ratio),
                               float(ref.inlier_ratio), atol=2e-3)


_FORCED = dict(dist_mean_threshold=0.0, dist_diff_threshold=-1e30)


@pytest.mark.parametrize("forced", [False, True])
@pytest.mark.parametrize("centered", [False, True])
def test_icp_point_to_point_matches_jax(forced, centered):
    rng = np.random.default_rng(3)
    pr, pm, m = _pair(rng, _cloud(rng, 900), 3.0, [4.0, -3.0, 2.0], 1024)
    icp = cfg.IcpConfig(centered_covariance=centered,
                        **(_FORCED if forced else {}))
    ref = jax_icp.icp_point_to_point(jnp.asarray(pr), jnp.asarray(pm),
                                     jnp.asarray(m), icp)
    got = port_icp.icp_point_to_point(_t(pr), _t(pm), _t(m), icp)
    _icp_equal(got, ref)
    assert int(got.iterations) >= 2


def _anisotropy(nrm):
    evals = np.linalg.eigvalsh(nrm.T.astype(np.float64) @ nrm / len(nrm))
    return evals[1] / evals[2]


@pytest.mark.parametrize("surface,branch", [("bowl", "gauss_newton"),
                                            ("plane", "kabsch")])
@pytest.mark.parametrize("forced", [False, True])
def test_icp_point_to_plane_matches_jax(surface, branch, forced):
    """Both branches of the plane mode: the bowl's normals are spread
    (Gauss-Newton), the plane's are one direction (Kabsch)."""
    rng = np.random.default_rng(4)
    pts, nrm = _bowl() if surface == "bowl" else _plane()
    icp = cfg.IcpConfig(mode="point_to_plane",
                        **(_FORCED if forced else {}))
    assert (_anisotropy(nrm) > icp.plane_min_normal_anisotropy) == (
        branch == "gauss_newton")
    pr, pm, m = _pair(rng, pts, 2.0, [3.0, 2.0, -2.5], 1024)
    pn = np.zeros((1024, 3), np.float32)
    pn[:len(nrm)] = nrm
    ref = jax_icp.icp_point_to_plane(jnp.asarray(pr), jnp.asarray(pn),
                                     jnp.asarray(pm), jnp.asarray(m), icp)
    got = port_icp.icp_refine(_t(pr), _t(pm), _t(m), icp, ref_normals=_t(pn))
    _icp_equal(got, ref)
    assert int(got.iterations) >= 2          # NN correspondences ran


@pytest.mark.parametrize("mode", ["point_to_point", "point_to_plane"])
@pytest.mark.parametrize("setting,iters,nn_calls", [("converged", 0, 0),
                                                    ("forced", 10, 9)])
def test_icp_loop_stops_like_jax_and_calls_nn_per_iteration(
        monkeypatch, mode, setting, iters, nn_calls):
    """The host-checked loop runs JAX's number of iterations and calls NN
    once per iteration after the first: an ICP that has converged at
    initialisation calls it never."""
    calls = []
    real_nn = port_icp.nn.nearest_neighbor

    def counting_nn(q, r):
        calls.append(q.shape[0])
        return real_nn(q, r)

    monkeypatch.setattr(port_icp.nn, "nearest_neighbor", counting_nn)
    rng = np.random.default_rng(8)
    pts, nrm = _bowl()
    pr, pm, m = _pair(rng, pts, 1.0, [1.0, -1.0, 0.5], 1024)
    pn = np.zeros((1024, 3), np.float32)
    pn[:len(nrm)] = nrm
    icp = cfg.IcpConfig(mode=mode, **(
        _FORCED if setting == "forced" else dict(dist_mean_threshold=1e9)))
    ref = jax_icp.icp_refine(jnp.asarray(pr), jnp.asarray(pm), jnp.asarray(m),
                             icp, ref_normals=jnp.asarray(pn))
    got = port_icp.icp_refine(_t(pr), _t(pm), _t(m), icp, ref_normals=_t(pn))
    _icp_equal(got, ref)
    assert int(got.iterations) == iters
    assert len(calls) == nn_calls


def test_icp_too_few_points_is_not_ok():
    rng = np.random.default_rng(5)
    pr, pm, m = _pair(rng, _cloud(rng, 2), 1.0, [1.0, 0, 0], 64)
    for mode in ("point_to_point", "point_to_plane"):
        icp = cfg.IcpConfig(mode=mode)
        normals = _t(np.zeros((64, 3), np.float32))
        got = port_icp.icp_refine(_t(pr), _t(pm), _t(m), icp,
                                  ref_normals=normals)
        assert not bool(got.ok) and float(got.dist_mean) == -1.0
        assert int(got.iterations) == icp.max_iterations
        np.testing.assert_array_equal(got.r.numpy(), np.eye(3))


def test_transforms_match_jax():
    rng = np.random.default_rng(6)
    for w in [rng.normal(size=3) * 0.5, np.array([1e-9, -2e-9, 5e-10])]:
        w = w.astype(np.float32)
        np.testing.assert_allclose(port_tf.so3_exp(_t(w)).numpy(),
                                   np.asarray(jax_tf.so3_exp(jnp.asarray(w))),
                                   atol=1e-6)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    mask = rng.random(50) < 0.5
    np.testing.assert_allclose(
        port_tf.masked_mean(_t(pts), _t(mask)).numpy(),
        np.asarray(jax_tf.masked_mean(jnp.asarray(pts), jnp.asarray(mask))),
        rtol=1e-6)
    pose13 = rng.normal(size=13).astype(np.float32)
    r, t, dist = port_tf.pose_from_13floats(_t(pose13))
    jr, jt, jd = jax_tf.pose_from_13floats(jnp.asarray(pose13))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    assert float(dist) == float(jd)
    np.testing.assert_array_equal(
        port_tf.pose_matrix_4x4(r, t).numpy(),
        np.asarray(jax_tf.pose_matrix_4x4(jr, jt)))


def _depth_image(rng, h=48, w=64):
    yy, xx = np.mgrid[0:h, 0:w]
    depth = (650 + 0.05 * (xx - 30) ** 2 + 0.08 * (yy - 20) ** 2
             + rng.integers(0, 3, (h, w))).astype(np.uint16)
    depth[5:9, 10:20] = 0
    depth[30:, 50:] = 1200
    return depth


def test_crop_points_and_normals_match_jax():
    """Zero depth becomes NaN (the z-gates compare False on it), and an
    origin off the image reads the zero padding as JAX pads it, not a
    window clamped back inside."""
    rng = np.random.default_rng(7)
    depth = _depth_image(rng)
    k = np.array([[608.0, 0, 31.5], [0, 608.0, 23.5], [0, 0, 1]], np.float32)
    for x0, y0 in [(3, 2), (40, 30), (-5, 60)]:
        want = np.asarray(jax_pipe._crop_points_mm(
            jnp.asarray(depth), jnp.asarray(k), x0, y0, 24, 32))
        got = port_pipe._crop_points_mm(_t(depth.astype(np.int32)), _t(k),
                                        x0, y0, 24, 32).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, equal_nan=True)
        n_want = np.asarray(jax_depth.normals_from_point_image(
            jnp.asarray(want)))
        n_got = port_depth.normals_from_point_image(_t(got)).numpy()
        np.testing.assert_allclose(n_got, n_want, atol=2e-5)
    np.testing.assert_array_equal(
        port_depth.intrinsics_matrix(1.0, 2.0, 3.0, 4.0).numpy(),
        np.asarray(jax_depth.intrinsics_matrix(1.0, 2.0, 3.0, 4.0)))


@pytest.mark.parametrize("mode", ["point_to_point", "point_to_plane"])
def test_refine_match_matches_jax(mode):
    """detection() glue end to end on a shifted depth pair, with a point
    cap below the crop size so the stable compaction runs."""
    rng = np.random.default_rng(8)
    scene = _depth_image(rng)
    model = np.roll(scene, (2, -3), (0, 1))
    k = np.array([[608.0, 0, 31.5], [0, 608.0, 23.5], [0, 0, 1]], np.float32)
    engine = cfg.EngineConfig(icp=cfg.IcpConfig(mode=mode, max_points=900,
                                                **_FORCED))
    r_match = np.eye(3, dtype=np.float32)
    t_match = np.array([1.0, -2.0, 650.0], np.float32)
    args = (40, 36, 6, 4, 8, 5)   # rect w, h; model origin; match origin
    want = jax_pipe.refine_match(jnp.asarray(scene), jnp.asarray(k),
                                 jnp.asarray(model), jnp.asarray(k), *args,
                                 jnp.asarray(r_match), jnp.asarray(t_match),
                                 engine, crop_h=40, crop_w=40)
    got = port_pipe.refine_match(_t(scene.astype(np.int32)), _t(k),
                                 _t(model.astype(np.int32)), _t(k), *args,
                                 _t(r_match), _t(t_match), engine,
                                 crop_h=40, crop_w=40)
    assert int(got.n_pairs) == int(want.n_pairs) == 900
    _icp_equal(got.icp, want.icp)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t),
                               atol=T_TOL_MM)
    assert _rot_diff_deg(got.r.numpy(), np.asarray(want.r)) <= ROT_TOL_DEG
