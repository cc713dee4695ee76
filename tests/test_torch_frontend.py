"""The port's quantization front-end held bit-exact against the JAX
package: the five image primitives, both quantizers and the decimated
response planes at both pyramid levels, on seeded random images and on
the fixture scene."""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fealess_tpu import config as cfg
from fealess_tpu import detector as jax_det
from fealess_tpu.ops import image as jax_img
from fealess_tpu.ops import luts
from fealess_tpu.ops import quantize as jax_q
from fealess_tpu.ops import response as jax_resp
from fealess_tpu_torch import detector as port_det
from fealess_tpu_torch.ops import image as port_img
from fealess_tpu_torch.ops import luts as port_luts
from fealess_tpu_torch.ops import quantize as port_q
from fealess_tpu_torch.ops import response as port_resp
from tests.test_torch_config import to_port

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks", "reference", "out")


def _eq(port, ref):
    ref = np.asarray(ref)
    got = port.numpy()
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_array_equal(got, ref)


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(21)
    bgr = rng.integers(0, 256, (40, 60, 3), dtype=np.uint8)
    # smooth structure plus noise, so gradients have a dominant channel
    yy, xx = np.mgrid[0:40, 0:60]
    bgr[..., 1] = np.clip(128 + 100 * np.sin(xx / 5.0) * np.cos(yy / 7.0)
                          + rng.normal(0, 8, (40, 60)), 0, 255)
    depth = (700 + 2 * xx + 3 * yy + rng.integers(0, 40, (40, 60))
             ).astype(np.uint16)
    depth[5:12, 30:45] = 0
    depth[20:30, 5:15] = 2500
    return bgr, depth


def test_round_half_to_even_pin():
    """cvRound / jnp.rint / np.rint round half to even; torch.round must
    too (the gradient-bin quantization depends on it)."""
    x = np.array([0.5, 1.5, 2.5, 3.5, -0.5, -1.5, -2.5, 15.5, 16.5, 7.5],
                 np.float32)
    want = np.rint(x)
    np.testing.assert_array_equal(np.asarray(jnp.rint(jnp.asarray(x))), want)
    np.testing.assert_array_equal(torch.round(torch.from_numpy(x)).numpy(),
                                  want)


def test_image_primitives_bit_exact(images):
    bgr, _ = images
    t_bgr = torch.from_numpy(bgr)
    _eq(port_img.gaussian_blur7_u8(t_bgr),
        jax_img.gaussian_blur7_u8(jnp.asarray(bgr)))
    for axis in ("x", "y"):
        _eq(port_img.sobel3_i16(t_bgr, axis),
            jax_img.sobel3_i16(jnp.asarray(bgr), axis))
    _eq(port_img.pyr_down_u8(t_bgr), jax_img.pyr_down_u8(jnp.asarray(bgr)))
    gray = np.ascontiguousarray(bgr[..., 1])
    _eq(port_img.pyr_down_u8(torch.from_numpy(gray)),
        jax_img.pyr_down_u8(jnp.asarray(gray)))
    # OpenCV goldens for the same calls
    np.testing.assert_array_equal(
        port_img.gaussian_blur7_u8(t_bgr).numpy(),
        cv2.GaussianBlur(bgr, (7, 7), 0, borderType=cv2.BORDER_REPLICATE))
    np.testing.assert_array_equal(port_img.pyr_down_u8(t_bgr).numpy(),
                                  cv2.pyrDown(bgr))


def test_median_blur5_bit_exact():
    rng = np.random.default_rng(4)
    bits = np.array([0] + [1 << k for k in range(8)], np.uint8)
    img = bits[rng.integers(0, 9, (33, 47))]
    img[10:20, 10:30] = 8
    _eq(port_img.median_blur5_u8(torch.from_numpy(img)),
        jax_img.median_blur5_u8(jnp.asarray(img)))
    np.testing.assert_array_equal(
        port_img.median_blur5_u8(torch.from_numpy(img)).numpy(),
        cv2.medianBlur(img, 5))


def test_fast_atan2_bit_exact():
    rng = np.random.default_rng(9)
    y = rng.integers(-1020, 1021, 4000).astype(np.float32)
    x = rng.integers(-1020, 1021, 4000).astype(np.float32)
    y[:20] = 0
    x[10:30] = 0
    _eq(port_img.fast_atan2_deg(torch.from_numpy(y), torch.from_numpy(x)),
        jax_img.fast_atan2_deg(jnp.asarray(y), jnp.asarray(x)))


def test_quantize_gradients_bit_exact(images):
    bgr, _ = images
    q_p, mag_p = port_q.quantize_gradients(torch.from_numpy(bgr), 10.0)
    q_j, mag_j = jax_q.quantize_gradients(jnp.asarray(bgr), 10.0)
    _eq(q_p, q_j)
    _eq(mag_p, mag_j)
    assert (q_p.numpy() > 0).sum() > 100


def test_quantize_normals_bit_exact(images):
    _, depth = images
    got = port_q.quantize_normals(torch.from_numpy(depth.astype(np.int32)),
                                  2000, 50)
    _eq(got, jax_q.quantize_normals(jnp.asarray(depth), 2000, 50))
    assert (got.numpy() > 0).sum() > 100


def test_azimuth_bins_over_the_whole_grid():
    iy, ix = np.meshgrid(np.arange(20, dtype=np.int32),
                         np.arange(20, dtype=np.int32), indexing="ij")
    got = port_q._azimuth_bin_from_grid(torch.from_numpy(ix),
                                        torch.from_numpy(iy))
    _eq(got, jax_q._azimuth_bin_from_grid(jnp.asarray(ix), jnp.asarray(iy)))
    np.testing.assert_array_equal(got.numpy(), luts.normal_lut()[0])


def test_apply_mask_bit_exact(images):
    bgr, _ = images
    q = np.ascontiguousarray(bgr[..., 0] & 0x81)
    mask = np.arange(q.size).reshape(q.shape) % 3 == 0
    _eq(port_q.apply_mask(torch.from_numpy(q), torch.from_numpy(mask)),
        jax_q.apply_mask(jnp.asarray(q), jnp.asarray(mask)))
    assert port_q.apply_mask(torch.from_numpy(q), None) is not None


@pytest.mark.parametrize("t", [5, 8, 4])
def test_build_level_2d_bit_exact(t):
    rng = np.random.default_rng(t)
    bits = np.array([0] + [1 << k for k in range(8)], np.uint8)
    q = bits[rng.integers(0, 9, (t * 6, t * 9))]
    _eq(port_resp.build_level_2d(torch.from_numpy(q), t),
        jax_resp.build_level_2d(jnp.asarray(q), t))
    # against the full-resolution definition: spread -> responses -> decimate
    want = jax_resp.decimate_2d(jax_resp.response_maps(
        jax_resp.spread(jnp.asarray(q), t)), t)
    np.testing.assert_array_equal(
        port_resp.build_level_2d(torch.from_numpy(q), t).numpy(),
        np.asarray(want).astype(np.int32))
    assert port_resp.ORIENTATION_SCORES is port_luts.ORIENTATION_SCORES
    assert tuple(port_luts.ORIENTATION_SCORES) == tuple(
        luts.ORIENTATION_SCORES)


def _pyramid_and_planes_equal(bgr, depth, det):
    jax_fn = jax.jit(lambda b, d: jax_det.response_planes(
        jax_det.quantized_pyramid(b, d, det), det))
    j_planes = jax_fn(jnp.asarray(bgr), jnp.asarray(depth))
    levels = port_det.quantized_pyramid(
        torch.from_numpy(bgr), torch.from_numpy(depth.astype(np.int32)),
        to_port(det))
    p_planes = port_det.response_planes(levels, to_port(det))
    assert len(p_planes) == det.pyramid_levels
    for (pp, phw), (jp, jhw) in zip(p_planes, j_planes):
        assert tuple(phw) == tuple(jhw)
        assert pp.dtype == torch.uint8
        np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    return p_planes


def test_response_planes_bit_exact_random(images):
    bgr, depth = images
    det = cfg.DetectorConfig(image_width=80, image_height=80)
    pad = ((0, 40), (0, 20))
    planes = _pyramid_and_planes_equal(np.pad(bgr, pad + ((0, 0),)),
                                       np.pad(depth, pad), det)
    assert planes[0][0].shape == (2 * 8 * 25, 16, 16)
    assert planes[1][0].shape == (2 * 8 * 64, 5, 5)


def test_response_planes_bit_exact_fixture_scene():
    bgr = cv2.imread(os.path.join(FIXTURE, "scene_bgr.png"))
    depth = cv2.imread(os.path.join(FIXTURE, "scene_depth.png"),
                       cv2.IMREAD_UNCHANGED)
    planes = _pyramid_and_planes_equal(bgr, depth, cfg.DetectorConfig())
    assert planes[0][0].shape == (400, 96, 128)
    assert planes[1][0].shape == (1024, 30, 40)
    assert int(planes[1][0].sum()) > 0
