"""The port's detector held exactly against the JAX package on the fixture
(128-slot prefix of benchmarks/reference/out, as bench.py slices it): the
packed bank, every Matches field, and the tie order among the fixture's
identical templates at the coarse top-K and after the class and ROI
gates."""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fealess_tpu import config as cfg
from fealess_tpu import detector as jax_det
from fealess_tpu.bank import pack_bank as jax_pack
from fealess_tpu.io import linemod_yaml as jax_yaml
from fealess_tpu_torch import detector as port_det
from fealess_tpu_torch.bank import bank_from_numpy
from fealess_tpu_torch.bank import pack_bank as port_pack
from fealess_tpu_torch.io import linemod_yaml as port_yaml

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
                         jb.class_names, jb.max_span)
    bgr = cv2.imread(os.path.join(FIXTURE, "scene_bgr.png"))
    depth = cv2.imread(os.path.join(FIXTURE, "scene_depth.png"),
                       cv2.IMREAD_UNCHANGED)
    jax_planes = jax.jit(lambda b, d: jax_det.response_planes(
        jax_det.quantized_pyramid(b, d, det), det))(jnp.asarray(bgr),
                                                    jnp.asarray(depth))
    # jit returned the static (h, w) as arrays; make them ints again
    jax_planes = [(a, (int(h), int(w))) for a, (h, w) in jax_planes]
    port_planes = port_det.response_planes(port_det.quantized_pyramid(
        torch.from_numpy(bgr), torch.from_numpy(depth.astype(np.int32)), det),
        det)
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
                    modalities=2, capacity=N_SLOTS)
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
    pt = port_det.build_match_tables(pb, det)
    ref = _jax_match(det)(jb, jax_planes, jt)
    got = port_det.match_from_planes(pb, port_planes, 75.0, det, pt)
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
    pt = port_det.build_match_tables(pb, det)
    sim, slot, x, y = port_det.coarse_candidates(pb, port_planes, 75.0, det,
                                                 pt)
    np.testing.assert_array_equal(sim.numpy(), np.asarray(ref.similarity))
    np.testing.assert_array_equal(slot.numpy(),
                                  np.asarray(ref.template_slot))
    np.testing.assert_array_equal(x.numpy(), np.asarray(ref.x))
    np.testing.assert_array_equal(y.numpy(), np.asarray(ref.y))
    # a real tie: many slots share the top score
    assert len(set(slot.numpy()[sim.numpy() == sim.numpy()[0]])) > 8


def test_match_class_and_roi_gates_exact(fixture):
    """The class_mask and roi_box gates pick the same tied slots and order
    as JAX."""
    det, jb, pb, jax_planes, port_planes, _ = fixture
    jt = jax_det.build_match_tables(jb, det)
    pt = port_det.build_match_tables(pb, det)
    class_mask = np.arange(N_SLOTS) % 3 == 1
    fn = _jax_match(det)
    for box in ([0.0, 0.0, 640.0, 480.0], [300.0, 200.0, 420.0, 300.0],
                [0.0, 0.0, 100.0, 100.0]):
        roi = np.asarray(box, np.float32)
        ref = fn(jb, jax_planes, jt, jnp.asarray(class_mask),
                 jnp.asarray(roi))
        got = port_det.match_from_planes(
            pb, port_planes, 75.0, det, pt,
            class_mask=torch.from_numpy(class_mask),
            roi_box=torch.from_numpy(roi))
        _matches_equal(got, ref)
