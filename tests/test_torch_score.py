"""The port's score tables and the plain twins of kernels K1 (coarse) and
K2 (local) held exactly against the JAX package's XLA contracts
(``_coarse_scores_xla``, ``_local_scores_xla``) on seeded random banks,
including negative window origins and features off the plane."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fealess_tpu import config as cfg
from fealess_tpu import detector as jax_det
from fealess_tpu.bank import TemplateBank as JaxBank
from fealess_tpu.ops import score_pallas
from fealess_tpu_torch import detector as port_det
from fealess_tpu_torch.bank import bank_from_numpy
from fealess_tpu_torch.ops import score

torch.set_num_threads(1)

_LEAVES = ("feat_x", "feat_y", "feat_label", "feat_valid", "width", "height",
           "offset_x", "offset_y", "pose", "class_idx", "template_idx",
           "valid")


def _random_banks(rng, n, levels, mods, f, span_px, max_span=None):
    """The same random bank for both packages (JAX bank, port bank)."""
    shape = (n, levels, mods, f)
    width = np.full((n, levels), span_px, np.int32)
    for l in range(1, levels):
        width[:, l] = span_px >> l
    fx = np.zeros(shape, np.int32)
    fy = np.zeros(shape, np.int32)
    for l in range(levels):
        fx[:, l] = rng.integers(0, max(span_px >> l, 1), (n, mods, f))
        fy[:, l] = rng.integers(0, max(span_px >> l, 1), (n, mods, f))
    leaves = dict(
        feat_x=fx, feat_y=fy,
        feat_label=rng.integers(0, 8, shape).astype(np.int32),
        feat_valid=rng.random(shape) < 0.7,
        width=width, height=width,
        offset_x=np.zeros((n, levels), np.int32),
        offset_y=np.zeros((n, levels), np.int32),
        pose=np.zeros((n, 13), np.float32),
        class_idx=np.zeros((n,), np.int32),
        template_idx=np.arange(n, dtype=np.int32),
        valid=np.ones((n,), bool))
    span = span_px + 1 if max_span is None else max_span
    jax_bank = JaxBank(**{k: jnp.asarray(v) for k, v in leaves.items()},
                       class_names=("obj",), max_span=span)
    return jax_bank, bank_from_numpy(leaves, ("obj",), span)


def _tables_equal(port_tables, jax_tables):
    for pt, jt in zip(port_tables, jax_tables):
        assert set(pt) == set(jt)
        for key in jt:
            assert pt[key].dtype == torch.int32
            np.testing.assert_array_equal(pt[key].numpy(),
                                          np.asarray(jt[key]), err_msg=key)


@pytest.mark.parametrize("span,max_span", [(40, None), (96, None),
                                           (40, 0)])
def test_build_match_tables_equal_jax(span, max_span):
    rng = np.random.default_rng(span)
    det = cfg.DetectorConfig(image_width=240, image_height=160)
    jb, pb = _random_banks(rng, 12, 2, 2, 20, span, max_span)
    assert np.array_equal(pb.num_features().numpy(),
                          np.asarray(jb.num_features()))
    _tables_equal(port_det.build_match_tables(pb, det),
                  jax_det.build_match_tables(jb, det))
    grid = [(20, 30), (8, 12)]
    _tables_equal(port_det.build_match_tables(pb, det, grid_hw=grid),
                  jax_det.build_match_tables(jb, det, grid_hw=grid))


def _coarse_case(seed, span_cells, hd, wd):
    rng = np.random.default_rng(seed)
    t = 8
    det = cfg.DetectorConfig(image_width=wd * t * 2, image_height=hd * t * 2)
    jb, pb = _random_banks(rng, 24, 2, 2, 16, span_cells * t)
    grid = [(hd * 2, wd * 2), (hd, wd)]
    jt = jax_det.build_match_tables(jb, det, grid_hw=grid)[1]
    pt = port_det.build_match_tables(pb, det, grid_hw=grid)[1]
    planes = rng.integers(0, 5, (2 * 8 * t * t, hd, wd), np.uint8)
    return planes, jt, pt


@pytest.mark.parametrize("seed,span_cells,hd,wd", [(0, 5, 12, 15),
                                                   (1, 9, 6, 7),
                                                   (2, 3, 30, 40)])
def test_coarse_twin_equals_jax(seed, span_cells, hd, wd):
    """K1's twin: exact against _coarse_scores_xla, also where template
    offsets reach past the plane (span larger than the grid)."""
    planes, jt, pt = _coarse_case(seed, span_cells, hd, wd)
    want = np.asarray(score_pallas._coarse_scores_xla(jnp.asarray(planes),
                                                      jt))
    got = score.coarse_scores_plain(torch.from_numpy(planes), pt)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper takes the twin for CPU tensors
    np.testing.assert_array_equal(
        score.coarse_scores(torch.from_numpy(planes), pt).numpy(), want)


def _local_case(seed):
    rng = np.random.default_rng(seed)
    t = 5
    hd, wd = 20, 26
    det = cfg.DetectorConfig(image_width=wd * t, image_height=hd * t)
    jb, pb = _random_banks(rng, 10, 2, 2, 16, 12 * t)
    grid = [(hd, wd), (hd // 2, wd // 2)]
    jt = jax_det.build_match_tables(jb, det, grid_hw=grid)[0]
    pt = port_det.build_match_tables(pb, det, grid_hw=grid)[0]
    planes = rng.integers(0, 5, (2 * 8 * t * t, hd, wd), np.uint8)
    k = 24
    slots = rng.integers(0, 10, k)
    # origins: in range, negative (degenerate clamps) and far enough right
    # and down that windows and features fall off the plane
    px0 = rng.integers(-12, wd + 4, k).astype(np.int32)
    py0 = rng.integers(-12, hd + 4, k).astype(np.int32)
    px0[:3] = [-5, 0, wd - 16]
    py0[:3] = [-7, hd - 16, hd]
    jtk = {key: v[jnp.asarray(slots)] for key, v in jt.items()}
    ptk = {key: v[torch.from_numpy(slots)] for key, v in pt.items()}
    return planes, jtk, ptk, px0, py0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_local_twin_equals_jax(seed):
    """K2's twin: exact against _local_scores_xla with its origin clamp,
    row gating and column clamp."""
    planes, jtk, ptk, px0, py0 = _local_case(seed)
    want = np.asarray(score_pallas._local_scores_xla(
        jnp.asarray(planes), jtk, jnp.asarray(px0), jnp.asarray(py0)))
    args = (torch.from_numpy(planes), ptk, torch.from_numpy(px0),
            torch.from_numpy(py0))
    got = score.local_scores_plain(*args)
    assert got.dtype == torch.int32 and got.shape == (24, 16, 16)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(score.local_scores(*args).numpy(), want)
    assert want.any()


def test_wrappers_refuse_devices_without_a_kernel():
    """Only CPU tensors take the twins; any other non-CUDA device raises
    instead of silently computing elsewhere."""
    planes, _, pt = _coarse_case(0, 5, 12, 15)
    meta = torch.empty(planes.shape, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        score.coarse_scores(meta, pt)
    with pytest.raises(ValueError):
        score.local_scores(meta, pt, pt["c"][:, 0], pt["c"][:, 0])
