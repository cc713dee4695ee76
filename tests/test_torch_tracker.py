"""The port's tracker stack held against the JAX package as it runs under
``jit`` (as the JAX tracker calls it):

- ``sample_patch_bilinear`` bitwise, windows inside and past the edges,
  one window and a batch;
- FHOG (``fhog31`` and its three stages) within rtol 1e-4 / atol 2e-5,
  the FHOG tolerance of tests/test_kcf_parity.py;
- BGR -> Lab over every u8 BGR triple: the port evaluates the powers in
  float64 (XLA's CPU cube root is glibc ``powf``, which no float32 torch
  op reproduces), so values differ by at most 1e-4 Lab units and the
  nearest-centroid decision differs on 2 of the 16777216 triples; the
  cell-pooled Lab histogram of a patch within 1e-6;
- ``KcfTracker``: init state, a 10-frame ROI trace for (hog, lab) in
  {(F, F), (T, F), (T, T)} within 0.05 px (the same scale choices),
  ``update_batch`` equal to per-state ``update``, and one update from a
  JAX state carried across by ``state_from_numpy``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fealess_tpu.ops.sampling import sample_patch_bilinear as jax_sample
from fealess_tpu.tracker import fhog as jax_fhog
from fealess_tpu.tracker import kcf as jax_kcf
from fealess_tpu_torch.ops.sampling import sample_patch_bilinear
from fealess_tpu_torch.tracker import fhog, kcf
from tests.test_tracker import _frame

torch.set_num_threads(1)

ROI_TOL_PX = 0.05
FHOG_TOL = dict(rtol=1e-4, atol=2e-5)
LAB_TOL = 1e-4
LAB_FLIPS = 2          # of 256**3 u8 BGR triples
_LEAVES = ("tmpl", "alphaf", "roi", "scale")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("out_hw", [(24, 32), (96, 104)])
def test_sample_patch_bitwise(out_hw):
    rng = np.random.default_rng(sum(out_hw))
    img = rng.integers(0, 256, (60, 80, 3), np.uint8)
    jit_sample = jax.jit(functools.partial(jax_sample, out_h=out_hw[0],
                                           out_w=out_hw[1]))
    # inside, hanging off every side, and past the bottom-right corner
    wins = np.float32([[10, 5, 32, 24], [-8, -6, 70, 61], [4, 8, 41, 30],
                       [70, 50, 33, 29], [-40, 30, 200, 90]])
    wins = np.concatenate([wins, np.trunc(rng.uniform(
        [-30, -30, 8, 8], [90, 70, 150, 120], (20, 4))).astype(np.float32)])
    for win in wins:
        want = np.asarray(jit_sample(jnp.asarray(img), *win))
        got = sample_patch_bilinear(_t(img), *_t(win), *out_hw)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(win))
    batch = sample_patch_bilinear(_t(img), *_t(wins.T.copy()), *out_hw)
    assert batch.shape == (len(wins), *out_hw, 3)
    for win, got in zip(wins, batch):
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jit_sample(jnp.asarray(img), *win)))
    gray = sample_patch_bilinear(_t(img[..., 1]), *_t(wins[0]), *out_hw)
    np.testing.assert_array_equal(
        gray.numpy(), np.asarray(jit_sample(jnp.asarray(img[..., 1]),
                                            *wins[0])))


def test_fhog_stages_match_jax():
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (2, 48, 40, 3)).astype(np.float32)
    raw = fhog.raw_feature_maps(_t(img), 4)
    norm = fhog.normalize_and_truncate(raw)
    pca = fhog.pca_feature_maps(norm)
    assert pca.shape == (2, 10, 8, 31)
    for b in range(2):
        j_raw = jax_fhog.raw_feature_maps(jnp.asarray(img[b]), 4)
        j_norm = jax_fhog.normalize_and_truncate(j_raw)
        np.testing.assert_allclose(raw[b].numpy(), np.asarray(j_raw),
                                   **FHOG_TOL)
        np.testing.assert_allclose(norm[b].numpy(), np.asarray(j_norm),
                                   **FHOG_TOL)
        np.testing.assert_allclose(
            pca[b].numpy(), np.asarray(jax_fhog.pca_feature_maps(j_norm)),
            **FHOG_TOL)
        np.testing.assert_allclose(
            fhog.fhog31(_t(img[b]), 4).numpy(),
            np.asarray(jax_fhog.fhog31(jnp.asarray(img[b]), 4)), **FHOG_TOL)
    np.testing.assert_array_equal(fhog._cell_weights(4),
                                  jax_fhog._cell_weights(4))


def test_lab_over_every_u8_triple():
    cent = jnp.asarray(jax_kcf.LAB_CENTROIDS)
    np.testing.assert_array_equal(kcf.LAB_CENTROIDS, jax_kcf.LAB_CENTROIDS)

    @jax.jit
    def jax_lab(bgr):
        lab = jax_kcf._bgr_to_lab_u8scale(bgr)
        d = jnp.sum((lab[..., None, :] - cent) ** 2, axis=-1)
        return lab, jnp.argmin(d, axis=-1)

    cent_t = _t(kcf.LAB_CENTROIDS)
    v = np.arange(256, dtype=np.float32)
    g, r = np.meshgrid(v, v, indexing="ij")
    flips, err = 0, 0.0
    for b in range(256):
        bgr = np.stack([np.full_like(g, b), g, r], -1)
        want, want_c = (np.asarray(a) for a in jax_lab(jnp.asarray(bgr)))
        lab = kcf._bgr_to_lab_u8scale(_t(bgr))
        nearest = ((lab[..., None, :] - cent_t) ** 2).sum(-1).argmin(-1)
        flips += int((nearest.numpy() != want_c).sum())
        err = max(err, float(np.abs(lab.numpy() - want).max()))
    assert err <= LAB_TOL
    assert flips <= LAB_FLIPS


def test_lab_histogram_matches_jax():
    cfg = jax_kcf.kcf_reference_config(hog=True, lab=True)
    rng = np.random.default_rng(8)
    frame = _frame(50, 40, 24, noise_rng=rng)
    jt, pt = jax_kcf.KcfTracker(cfg), kcf.KcfTracker(cfg)
    jt.init((38, 28, 24, 24), frame)
    pt.init((38, 28, 24, 24), frame)
    tw, th = pt._geom[:2]
    patch = rng.uniform(0, 255, (th, tw, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jt._lab)(jnp.asarray(patch)))
    got = pt._lab(_t(patch[None]))[0]
    assert got.shape == want.shape == (15, pt._geom[2], pt._geom[3])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def _trace(cfg, frames, roi0):
    jt, pt = jax_kcf.KcfTracker(cfg), kcf.KcfTracker(cfg)
    js, ps = jt.init(roi0, frames[0]), pt.init(roi0, frames[0])
    out = []
    for f in frames[1:]:
        js, jr = jt.update(js, f)
        ps, pr = pt.update(ps, f)
        out.append((np.asarray(jr), pr))
    return (jt, js), (pt, ps), out


def _frames(n=11):
    rng = np.random.default_rng(5)
    frames, cx, cy = [], 40.0, 40.0
    for i in range(n):
        frames.append(_frame(cx, cy, 24 + (i % 3), noise_rng=rng))
        cx, cy = cx + 2.0, cy + 1.0
    return frames


@pytest.mark.parametrize("hog,lab", [(False, False), (True, False),
                                     (True, True)])
def test_kcf_trace_matches_jax(hog, lab):
    cfg = jax_kcf.kcf_reference_config(hog=hog, lab=lab)
    (jt, js0), (pt, ps0), trace = _trace(cfg, _frames()[:1],
                                         (28, 28, 24, 24))
    assert pt._geom == jt._geom
    np.testing.assert_allclose(pt._hann.numpy(), jt._hann, rtol=0, atol=0)
    (_, js), (_, ps), trace = _trace(cfg, _frames(), (28, 28, 24, 24))
    for want, got in trace:
        np.testing.assert_allclose(got, want, atol=ROI_TOL_PX, rtol=0)
        assert got[2] == want[2] and got[3] == want[3]   # scale choices
    np.testing.assert_allclose(ps.tmpl.numpy(), np.asarray(js.tmpl),
                               atol=1e-4, rtol=1e-3)


def test_kcf_init_state_matches_jax():
    cfg = jax_kcf.kcf_reference_config()
    frame = _frames()[0]
    js = jax_kcf.KcfTracker(cfg).init((28, 28, 24, 24), frame)
    ps = kcf.KcfTracker(cfg).init((28, 28, 24, 24), frame)
    assert ps.tmpl.shape == tuple(js.tmpl.shape)
    assert ps.alphaf.dtype == torch.complex64
    np.testing.assert_allclose(ps.tmpl.numpy(), np.asarray(js.tmpl),
                               rtol=1e-5, atol=1e-6)
    # alphaf = y^ / (k^ + 1e-4) amplifies the FFTs' last-bit differences
    # where k^ is small: 0.09% of max |alphaf| measured
    a = np.asarray(js.alphaf)
    np.testing.assert_allclose(ps.alphaf.numpy(), a,
                               atol=2e-3 * np.abs(a).max(), rtol=0)
    np.testing.assert_array_equal(ps.roi.numpy(), np.asarray(js.roi))
    assert float(ps.scale) == float(js.scale)


def test_update_batch_equals_per_state_update():
    """Equal up to float32 summation order: a batch axis regroups the
    einsum and sum reductions, which moves ROIs by an ulp (1e-4 px
    bound); the scale choices are equal."""
    cfg = jax_kcf.kcf_reference_config()
    frames = _frames(3)
    tr = kcf.KcfTracker(cfg)
    rois = ((28, 28, 24, 24), (30, 26, 24.2, 24.3), (27, 29, 24.3, 24))
    states = [tr.init(roi, frames[0]) for roi in rois]
    assert len({tr._fit_template(r[2], r[3]) for r in rois}) == 1
    for f in frames[1:]:
        batch = tr.update_batch(kcf.KcfTracker.stack_states(states), f)
        for i, b in enumerate(kcf.KcfTracker.unstack_states(batch)):
            single, roi = tr.update(states[i], f)
            np.testing.assert_allclose(b.roi.numpy(), roi, atol=1e-4, rtol=0)
            np.testing.assert_array_equal(b.roi.numpy()[2:], roi[2:])
            np.testing.assert_allclose(b.tmpl.numpy(), single.tmpl.numpy(),
                                       rtol=1e-5, atol=1e-6)
            states[i] = b


def test_update_from_carried_jax_state():
    """JAX tracks 4 frames; its state is carried into the port, and one
    more update agrees with JAX's."""
    cfg = jax_kcf.kcf_reference_config()
    frames = _frames(6)
    jt = jax_kcf.KcfTracker(cfg)
    js = jt.init((28, 28, 24, 24), frames[0])
    for f in frames[1:5]:
        js, _ = jt.update(js, f)
    pt = kcf.KcfTracker(cfg)
    pt.init((28, 28, 24, 24), frames[0])        # the same geometry
    ps = kcf.state_from_numpy({k: np.asarray(getattr(js, k))
                               for k in _LEAVES})
    assert ps.alphaf.dtype == torch.complex64 and ps.scale.dim() == 0
    js, want = jt.update(js, frames[5])
    ps, got = pt.update(ps, frames[5])
    np.testing.assert_allclose(got, np.asarray(want), atol=ROI_TOL_PX,
                               rtol=0)
    assert got[2] == float(want[2])
