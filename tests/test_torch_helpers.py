"""The port's public geometry and image helpers against the JAX package's,
on the same seeded inputs: ``geometry/transforms`` (transform_points,
compose_rt, kabsch with the reference's non-centred covariance,
rotation_geodesic_deg, add_metric) and ``geometry/depth`` (depth_to_3d_mm,
valid_mm) within 1e-5 (relative for mm values); ``ops/image``
(resize_nn_half, erode3_bool), ``ops/luts`` (similarity_lut, normal_lut,
normal_azimuth_bin, MAX_RESPONSE) and ``icp.pad_cloud`` exactly; and
ICP's alignment step, which now calls ``transforms.svd_align``, bitwise
equal to the sequence it replaced."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fealess_tpu import icp as jax_icp
from fealess_tpu.geometry import depth as jax_depth
from fealess_tpu.geometry import transforms as jax_tf
from fealess_tpu.ops import image as jax_image
from fealess_tpu.ops import luts as jax_luts
from fealess_tpu_torch import icp
from fealess_tpu_torch.geometry import depth
from fealess_tpu_torch.geometry import transforms as tf
from fealess_tpu_torch.ops import image, luts

torch.set_num_threads(1)

TOL = 1e-5


def _rotation(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                      2 * (x * z + y * w)],
                     [2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                      2 * (y * z - x * w)],
                     [2 * (x * z - y * w), 2 * (y * z + x * w),
                      1 - 2 * (x * x + y * y)]], np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("seed", range(4))
def test_transforms_match_jax(seed):
    rng = np.random.default_rng(seed)
    pts = rng.normal(0, 100, (257, 3)).astype(np.float32)
    r1, r2 = _rotation(rng), _rotation(rng)
    t1 = rng.normal(0, 50, 3).astype(np.float32)
    t2 = rng.normal(0, 50, 3).astype(np.float32)
    np.testing.assert_allclose(
        tf.transform_points(_t(pts), _t(r1), _t(t1)).numpy(),
        np.asarray(jax_tf.transform_points(pts, r1, t1)), rtol=TOL,
        atol=TOL * 100)
    got_r, got_t = tf.compose_rt(_t(r1), _t(t1), _t(r2), _t(t2))
    want_r, want_t = jax_tf.compose_rt(r1, t1, r2, t2)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), atol=TOL)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=TOL,
                               atol=TOL * 50)
    np.testing.assert_allclose(
        float(tf.rotation_geodesic_deg(_t(r1), _t(r2))),
        float(jax_tf.rotation_geodesic_deg(r1, r2)), atol=1e-3)
    assert float(tf.rotation_geodesic_deg(_t(r1), _t(r1))) < 0.05
    np.testing.assert_allclose(
        float(tf.add_metric(_t(r1), _t(t1), _t(r2), _t(t2), _t(pts))),
        float(jax_tf.add_metric(r1, t1, r2, t2, pts)), rtol=TOL)


@pytest.mark.parametrize("seed", range(4))
def test_kabsch_matches_jax(seed):
    """Noisy correspondences under a random pose and a random mask: the
    non-centred step's R*, T* and ok as JAX's (HIGHEST precision)."""
    rng = np.random.default_rng(10 + seed)
    model = rng.normal(0, 60, (400, 3)).astype(np.float32)
    r, t = _rotation(rng), rng.normal(0, 30, 3).astype(np.float32)
    ref = (model @ r.T + t + rng.normal(0, 0.5, model.shape)).astype(
        np.float32)
    mask = rng.random(400) < 0.8
    with jax.default_matmul_precision("highest"):
        want = jax_tf.kabsch(jnp.asarray(model), jnp.asarray(ref),
                             jnp.asarray(mask))
    got = tf.kabsch(_t(model), _t(ref), _t(mask))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=TOL * 100)
    assert bool(got[2]) and bool(want[2])


def test_kabsch_non_finite_gives_identity():
    model = torch.full((8, 3), float("nan"))
    r, t, ok = tf.kabsch(model, model.clone(), torch.ones(8, dtype=bool))
    want = jax_tf.kabsch(jnp.full((8, 3), jnp.nan), jnp.full((8, 3), jnp.nan),
                         jnp.ones(8, bool))
    assert not bool(ok) and not bool(want[2])
    np.testing.assert_array_equal(r.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(t.numpy(), np.asarray(want[1]))


def test_icp_alignment_step_is_unchanged():
    """``svd_align`` is the former private ICP step op for op: bitwise."""
    rng = np.random.default_rng(4)
    cov = _t(rng.normal(0, 1e4, (3, 3)).astype(np.float32))
    mc = _t(rng.normal(0, 100, 3).astype(np.float32))
    rc = _t(rng.normal(0, 100, 3).astype(np.float32))
    u, _, vt = torch.linalg.svd(cov)
    r_opt = vt.T @ u.T
    t_opt = rc - r_opt @ mc
    r, t, finite = tf.svd_align(cov, mc, rc)
    assert torch.equal(r, r_opt) and torch.equal(t, t_opt) and bool(finite)


@pytest.mark.parametrize("seed", range(3))
def test_depth_helpers_match_jax(seed):
    rng = np.random.default_rng(20 + seed)
    d = rng.integers(0, 1400, (48, 64)).astype(np.uint16)
    d[rng.random(d.shape) < 0.2] = 0
    k = np.array([[570.3, 0, 31.7], [0, 568.1, 24.2], [0, 0, 1]],
                 np.float32)
    got = depth.depth_to_3d_mm(_t(d.astype(np.int32)), _t(k)).numpy()
    want = np.asarray(jax_depth.depth_to_3d_mm(jnp.asarray(d),
                                               jnp.asarray(k)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    for limit in (900.0, 500.0):
        np.testing.assert_array_equal(
            depth.valid_mm(_t(got), limit).numpy(),
            np.asarray(jax_depth.valid_mm(jnp.asarray(want), limit)))


def test_image_helpers_match_jax():
    rng = np.random.default_rng(30)
    img = rng.integers(0, 256, (36, 50, 3), dtype=np.uint8)
    np.testing.assert_array_equal(image.resize_nn_half(_t(img)).numpy(),
                                  np.asarray(jax_image.resize_nn_half(img)))
    for p in (0.5, 0.85, 0.97):
        mask = rng.random((37, 41)) < p
        for it in (1, 2, 3):
            np.testing.assert_array_equal(
                image.erode3_bool(_t(mask), it).numpy(),
                np.asarray(jax_image.erode3_bool(jnp.asarray(mask), it)))


def test_luts_match_jax():
    assert luts.MAX_RESPONSE == jax_luts.MAX_RESPONSE
    got = luts.similarity_lut()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, jax_luts.similarity_lut())
    for g in (20, 8):
        np.testing.assert_array_equal(luts.normal_lut(g),
                                      jax_luts.normal_lut(g))
    rng = np.random.default_rng(31)
    nx, ny = rng.normal(size=(2, 1000))
    np.testing.assert_array_equal(luts.normal_azimuth_bin(nx, ny),
                                  jax_luts.normal_azimuth_bin(nx, ny))


@pytest.mark.parametrize("n,capacity", [(10, 16), (16, 16), (20, 12)])
def test_pad_cloud_matches_jax(n, capacity):
    rng = np.random.default_rng(n)
    pts = rng.normal(0, 100, (n, 3))
    mask = rng.random(n) < 0.7
    got = icp.pad_cloud(pts, mask, capacity)
    want = jax_icp.pad_cloud(pts, mask, capacity)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
