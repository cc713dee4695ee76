"""The port's detector held exactly against the JAX package on the fixture
(128-slot prefix of benchmarks/reference/out, as bench.py slices it): the
packed bank, every Matches field, and the tie order among the fixture's
identical templates at the coarse top-K and after the class and ROI
gates."""

import dataclasses
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fealess_tpu import detector as jax_det
from fealess_tpu.bank import pack_bank as jax_pack
from fealess_tpu.io import linemod_yaml as jax_yaml
from fealess_tpu_torch import detector as port_det
from fealess_tpu_torch.bank import bank_from_numpy
from fealess_tpu_torch.bank import pack_bank as port_pack
from fealess_tpu_torch.io import linemod_yaml as port_yaml
from fealess_tpu_torch.ops import score
from tests.test_torch_config import to_port
from tests.test_torch_score import _random_banks

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks", "reference", "out")
N_SLOTS = 128
_LEAVES = ("feat_x", "feat_y", "feat_label", "feat_valid", "width", "height",
           "offset_x", "offset_y", "pose", "class_idx", "template_idx",
           "valid")
_FIELDS = ("x", "y", "similarity", "template_slot", "class_idx",
           "template_idx", "valid")


@pytest.fixture(scope="module")
def fixture():
    yml = os.path.join(FIXTURE, "features", "linemod_templates.yml")
    det, classes = jax_yaml.load_linemod(yml)
    classes = {"obj": classes["obj"][:N_SLOTS]}
    jb = jax_pack(classes, levels=2, modalities=2, capacity=N_SLOTS)
    pb = bank_from_numpy({k: np.asarray(getattr(jb, k)) for k in _LEAVES},
                         jb.class_names, jb.max_span, device="cpu")
    bgr = cv2.imread(os.path.join(FIXTURE, "scene_bgr.png"))
    depth = cv2.imread(os.path.join(FIXTURE, "scene_depth.png"),
                       cv2.IMREAD_UNCHANGED)
    jax_planes = jax.jit(lambda b, d: jax_det.response_planes(
        jax_det.quantized_pyramid(b, d, det), det))(jnp.asarray(bgr),
                                                    jnp.asarray(depth))
    # jit returned the static (h, w) as arrays; make them ints again
    jax_planes = [(a, (int(h), int(w))) for a, (h, w) in jax_planes]
    port_planes = port_det.response_planes(port_det.quantized_pyramid(
        torch.from_numpy(bgr), torch.from_numpy(depth.astype(np.int32)),
        to_port(det)), to_port(det))
    return det, jb, pb, jax_planes, port_planes, yml


def _jax_match(det, **kw):
    """jit of JAX match_from_planes with the planes' (h, w) passed as
    static Python ints."""
    def fn(bank, arrays, hws, tables, *args):
        planes = [(a, hw) for a, hw in zip(arrays, hws)]
        return jax_det.match_from_planes(bank, planes, 75.0, det, tables,
                                         *args, **kw)

    def call(bank, planes, tables, *args):
        hws = tuple(hw for _, hw in planes)
        jitted = jax.jit(fn, static_argnums=2)
        return jitted(bank, [a for a, _ in planes], hws, tables, *args)
    return call


def test_port_bank_equals_jax_bank(fixture):
    """The port's own loader + pack_bank gives the JAX bank's leaves, and
    so does bank_from_numpy of them."""
    det, jb, pb, _, _, yml = fixture
    _, classes = port_yaml.load_linemod(yml)
    own = port_pack({"obj": classes["obj"][:N_SLOTS]}, levels=2,
                    modalities=2, capacity=N_SLOTS, device="cpu")
    for bank in (own, pb):
        assert bank.class_names == jb.class_names
        assert bank.max_span == jb.max_span
        for k in _LEAVES:
            np.testing.assert_array_equal(getattr(bank, k).numpy(),
                                          np.asarray(getattr(jb, k)),
                                          err_msg=k)


def _matches_equal(port, ref):
    for f in _FIELDS:
        got = getattr(port, f).numpy()
        want = np.asarray(getattr(ref, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)


def test_match_bank_fixture_exact(fixture):
    """Every Matches field, valid rows and the rest, exactly as JAX; the
    similarity too, since the f32 score conversions keep JAX's operation
    order, and the final (similarity, template_idx) order."""
    det, jb, pb, jax_planes, port_planes, _ = fixture
    jt = jax_det.build_match_tables(jb, det)
    pt = port_det.build_match_tables(pb, to_port(det))
    ref = _jax_match(det)(jb, jax_planes, jt)
    got = port_det.match_from_planes(pb, port_planes, 75.0, to_port(det),
                                     pt)
    _matches_equal(got, ref)
    valid = got.valid.numpy()
    assert valid.sum() >= 1
    assert (got.x[0].item(), got.y[0].item()) == (237, 157)
    assert got.similarity[0].item() == 100.0
    assert got.template_slot[0].item() == 0


def test_coarse_topk_tie_order_matches_jax(fixture, monkeypatch):
    """The fixture's templates are identical, so the coarse top-K is one
    large tie: the port must keep jax.lax.top_k's (score desc, flat index
    asc) order, slot by slot and position by position."""
    det, jb, pb, jax_planes, port_planes, _ = fixture
    monkeypatch.setattr(jax_det, "ALLOW_PROFILE_STOPS", True)
    jt = jax_det.build_match_tables(jb, det)
    ref = _jax_match(det, profile_stop="topk")(jb, jax_planes, jt)
    pt = port_det.build_match_tables(pb, to_port(det))
    sim, slot, x, y = port_det.coarse_candidates(pb, port_planes, 75.0,
                                                 to_port(det), pt)
    np.testing.assert_array_equal(sim.numpy(), np.asarray(ref.similarity))
    np.testing.assert_array_equal(slot.numpy(),
                                  np.asarray(ref.template_slot))
    np.testing.assert_array_equal(x.numpy(), np.asarray(ref.x))
    np.testing.assert_array_equal(y.numpy(), np.asarray(ref.y))
    # a real tie: many slots share the top score
    assert len(set(slot.numpy()[sim.numpy() == sim.numpy()[0]])) > 8


@pytest.mark.parametrize("case", ["fixture", "seeded", "constant", "zero"])
def test_local_stage_matches_jax(fixture, monkeypatch, case):
    """The refinement levels (detector.refine_level, whose K2 runs
    score.local_refine's plain twin here) give JAX's local stage
    (``profile_stop="local"``: x, y, similarity, slot and valid bitwise) on
    the fixture, on a seeded random bank over random planes, and on planes
    whose 16x16 windows have many equal maxima: all 4 (equal sums wherever
    every feature lands on the plane) and all 0 (every cell ties, so the
    first maximum is cell 0)."""
    det, jb, pb, jax_planes, port_planes, _ = fixture
    if case != "fixture":
        det = dataclasses.replace(det, image_width=240, image_height=160)
        rng = np.random.default_rng(["seeded", "constant", "zero"].index(
            case))
        jb, pb = _random_banks(rng, 24, 2, 2, 20, 40)
        arrays = []
        for l, t in enumerate(det.t_at_level):
            h, w = 160 >> l, 240 >> l
            shape = (2 * 8 * t * t, h // t, w // t)
            fill = {"constant": 4, "zero": 0}.get(case)
            arrays.append((rng.integers(2, 5, shape).astype(np.uint8)
                           if fill is None else np.full(shape, fill,
                                                        np.uint8), (h, w)))
        jax_planes = [(jnp.asarray(a), hw) for a, hw in arrays]
        port_planes = [(torch.from_numpy(a), hw) for a, hw in arrays]
    monkeypatch.setattr(jax_det, "ALLOW_PROFILE_STOPS", True)
    ref = _jax_match(det, profile_stop="local")(
        jb, jax_planes, jax_det.build_match_tables(jb, det))
    pdet = to_port(det)
    tables = port_det.build_match_tables(pb, pdet)
    sim, tslot, x, y = port_det.coarse_candidates(pb, port_planes, 75.0,
                                                  pdet, tables)
    valid = torch.isfinite(sim)
    nf = pb.num_features()
    t0 = pdet.t_at_level[0]
    scores = score.local_refine_plain(
        port_planes[0][0], tables[0], tslot, x, y,
        pb.width, pb.height, nf, 0, t0, port_det._offset(t0),
        port_planes[0][1])[0].reshape(len(tslot), -1)
    for l in range(pdet.pyramid_levels - 2, -1, -1):
        x, y, sim = port_det.refine_level(pb, port_planes, pdet, tables, l,
                                          tslot, x, y, nf)
        valid = valid & (sim >= 75.0)
    for name, got in (("x", x), ("y", y), ("similarity", sim),
                      ("template_slot", tslot), ("valid", valid)):
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert x.dtype == torch.int32 and sim.dtype == torch.float32
    if case in ("constant", "zero"):     # windows with several maxima
        ties = (scores == scores.max(dim=1, keepdim=True).values).sum(1)
        assert (ties > 1).any()


def test_match_class_and_roi_gates_exact(fixture):
    """The class_mask and roi_box gates pick the same tied slots and order
    as JAX."""
    det, jb, pb, jax_planes, port_planes, _ = fixture
    jt = jax_det.build_match_tables(jb, det)
    pt = port_det.build_match_tables(pb, to_port(det))
    class_mask = np.arange(N_SLOTS) % 3 == 1
    fn = _jax_match(det)
    for box in ([0.0, 0.0, 640.0, 480.0], [300.0, 200.0, 420.0, 300.0],
                [0.0, 0.0, 100.0, 100.0]):
        roi = np.asarray(box, np.float32)
        ref = fn(jb, jax_planes, jt, jnp.asarray(class_mask),
                 jnp.asarray(roi))
        got = port_det.match_from_planes(
            pb, port_planes, 75.0, to_port(det), pt,
            class_mask=torch.from_numpy(class_mask),
            roi_box=torch.from_numpy(roi))
        _matches_equal(got, ref)


def _small_bank(jb, n):
    """The first ``n`` fixture slots with 16 x 16 px templates (8 x 8 at
    the coarse level), so every coarse cell may seed a candidate."""
    size = np.tile(np.asarray([16, 8], np.int32), (n, 1))
    leaves = {k: np.asarray(getattr(jb, k))[:n] for k in _LEAVES}
    leaves.update(width=size, height=size)
    jbank = jb.replace(**{k: jnp.asarray(v) for k, v in leaves.items()})
    pbank = bank_from_numpy(leaves, jb.class_names, jb.max_span, device="cpu")
    return jbank, pbank


# (raw score draw, Hd, Wd, max_candidates, slots): scores 200..248 around
# the fixture's raw threshold (~217 at 75%) tie within and across rows;
# "few" leaves most rows with fewer than K live cells; "none" masks every
# cell; Hd = Wd = 1 takes JAX's flat fallback (one cell a row).  Its other
# fallback, N * min(K, P) < K, means N * P < K, where JAX's flat top_k
# itself refuses K
@pytest.mark.parametrize("draw,hd,wd,k,n", [
    ("ties", 30, 40, 64, 128), ("ties", 7, 9, 5, 128),
    ("few", 30, 40, 64, 128), ("none", 12, 15, 64, 128),
    ("ties", 1, 1, 64, 128), ("few", 1, 1, 7, 96)])
def test_coarse_row_topk_matches_jax(fixture, monkeypatch, draw, hd, wd, k,
                                     n):
    """The coarse top-K gives what JAX's per-row top-K and merge give
    (score, slot, x, y), tie order included, on raw scores injected into
    both packages' coarse stage."""
    det, jb, _, _, _, _ = fixture
    det = dataclasses.replace(det, max_candidates=k)
    jbank, pbank = _small_bank(jb, n)
    rng = np.random.default_rng(hd * 100 + wd + k)
    vals = np.asarray([200, 220, 230, 248], np.int32)
    raw = vals[rng.integers(0, 4, (n, hd, wd))]
    if draw == "few":
        raw = np.where(rng.random((n, hd, wd)) < 0.01, raw, 100)
    elif draw == "none":
        raw[:] = 100
    raw[n // 2] = raw[0]                       # two identical rows
    t_c = det.t_at_level[-1]
    shape = (8, hd, wd)
    jax_planes = [(jnp.zeros(shape, jnp.uint8), (hd * 16, wd * 16)),
                  (jnp.zeros(shape, jnp.uint8), (hd * t_c, wd * t_c))]
    port_planes = [(torch.zeros(shape, dtype=torch.uint8), hw)
                   for _, hw in jax_planes]
    monkeypatch.setattr(jax_det, "ALLOW_PROFILE_STOPS", True)
    monkeypatch.setattr(jax_det.score_pallas, "coarse_scores",
                        lambda d, t: jnp.asarray(raw))
    monkeypatch.setattr(port_det.score, "coarse_scores",
                        lambda d, t: torch.from_numpy(raw))
    ref = _jax_match(det, profile_stop="topk")(
        jbank, jax_planes, jax_det.build_match_tables(jbank, det))
    tables = port_det.build_match_tables(pbank, to_port(det))
    sim, slot, x, y = port_det.coarse_candidates(pbank, port_planes, 75.0,
                                                 to_port(det), tables)
    np.testing.assert_array_equal(sim.numpy(), np.asarray(ref.similarity))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(ref.template_slot))
    np.testing.assert_array_equal(x.numpy(), np.asarray(ref.x))
    np.testing.assert_array_equal(y.numpy(), np.asarray(ref.y))
    live = np.isfinite(sim.numpy())
    if draw == "none":
        assert not live.any()
    elif draw == "ties":
        assert live.all() and (sim.numpy() == sim.numpy()[0]).sum() > 1
