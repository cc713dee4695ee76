"""``apps/visualize.py`` against the JAX package's (cv2.circle and numpy):
``draw_response`` bitwise on the fixture bank (128-slot prefix) and on a
random 6-modality bank, at T = 5 and 8, at offsets that clip at every
border, on colour and gray images; the circle itself bitwise to
``cv2.circle`` at thickness 2 for radius 0-16, inside the image and
clipped at each border (thickness 1 and 3 raise); ``blit_template``
bitwise; ``save_ply`` byte-equal with and without colours and a mask."""

import os

import cv2
import numpy as np
import pytest
import torch

from fealess_tpu.apps import visualize as jax_vis
from fealess_tpu.bank import pack_bank as jax_pack
from fealess_tpu.io import linemod_yaml as jax_yaml
from fealess_tpu_torch.apps import visualize as vis
from fealess_tpu_torch.bank import pack_bank as port_pack
from fealess_tpu_torch.io import linemod_yaml as port_yaml
from tests.test_torch_score import _random_banks

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks", "reference", "out")
N_SLOTS = 128


@pytest.fixture(scope="module")
def banks():
    yml = os.path.join(FIXTURE, "features", "linemod_templates.yml")
    _, jax_classes = jax_yaml.load_linemod(yml)
    _, classes = port_yaml.load_linemod(yml)
    fixture = (jax_pack({"obj": jax_classes["obj"][:N_SLOTS]}, levels=2,
                        modalities=2, capacity=N_SLOTS),
               port_pack({"obj": classes["obj"][:N_SLOTS]}, levels=2,
                         modalities=2, capacity=N_SLOTS, device="cpu"))
    random = _random_banks(np.random.default_rng(3), 4, 2, 6, 40, 150)
    return {"fixture": fixture, "random": random}


# (offset, image (h, w)): inside, and clipped at the left/top, the
# right/bottom, bottom-left and top-right corners
OFFSETS = [((237, 157), (480, 640)), ((-40, -30), (480, 640)),
           ((560, 420), (480, 640)), ((-60, 400), (480, 640)),
           ((520, -50), (480, 640)), ((-3, -3), (120, 100))]


@pytest.mark.parametrize("t", [5, 8])
@pytest.mark.parametrize("bank_name,slot,level", [("fixture", 0, 0),
                                                  ("fixture", 77, 1),
                                                  ("random", 2, 0),
                                                  ("random", 3, 1)])
def test_draw_response_matches_jax(banks, bank_name, slot, level, t):
    jb, pb = banks[bank_name]
    rng = np.random.default_rng(slot + 10 * t)
    for offset, (h, w) in OFFSETS:
        for shape in ((h, w, 3), (h, w)):
            base = rng.integers(0, 256, shape, dtype=np.uint8)
            want = jax_vis.draw_response(base.copy(), jb, slot, offset,
                                         level=level, t=t)
            got = vis.draw_response(base.copy(), pb, slot, offset,
                                    level=level, t=t)
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{offset} {shape}")
    # the default T is 5
    base = np.zeros((480, 640, 3), np.uint8)
    np.testing.assert_array_equal(
        vis.draw_response(base.copy(), pb, slot, (237, 157)),
        jax_vis.draw_response(base.copy(), jb, slot, (237, 157)))


@pytest.mark.parametrize("radius", range(17))
def test_circle_matches_cv2(radius):
    """``draw_circle`` inside the image, and near and past every border
    (the centre up to radius + 4 outside, on two image sizes)."""
    img = np.zeros((80, 80), np.uint8)
    cv2.circle(img, (40, 40), radius, 255, 2)
    np.testing.assert_array_equal(
        vis.draw_circle(np.zeros((80, 80), bool), 40, 40, radius),
        img.astype(bool))
    for h, w in ((12, 10), (25, 33)):
        for c in range(-radius - 4, radius + 5):
            for along in (-3, 0, 5, 12):
                for x, y in ((c, along), (w - 1 - c, along), (along, c),
                             (along, h - 1 - c)):
                    want = np.zeros((h, w), np.uint8)
                    cv2.circle(want, (x, y), radius, 255, 2)
                    got = vis.draw_circle(np.zeros((h, w), bool), x, y,
                                          radius)
                    np.testing.assert_array_equal(
                        got, want.astype(bool), err_msg=f"{(x, y)} {h}x{w}")


def test_circle_refuses_other_thicknesses():
    for thickness in (1, 3, -1):
        with pytest.raises(ValueError):
            vis.draw_circle(np.zeros((8, 8), bool), 4, 4, 2, thickness)


@pytest.mark.parametrize("offset", [(5, 7), (90, 60), (-8, -6), (95, 2),
                                    (-30, 10), (200, 5), (3, -40)])
def test_blit_template_matches_jax(offset):
    rng = np.random.default_rng(sum(offset) + 100)
    tpl = rng.integers(0, 256, (24, 20), dtype=np.uint8)
    for shape in ((64, 100), (64, 100, 3)):
        base = rng.integers(0, 256, shape, dtype=np.uint8)
        want = jax_vis.blit_template(base.copy(), tpl, offset)
        got = vis.blit_template(base.copy(), tpl, offset)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("colors,valid", [(False, False), (True, False),
                                          (False, True), (True, True)])
def test_save_ply_matches_jax(tmp_path, colors, valid):
    """Points with NaN rows (dropped by default); the port also takes the
    cloud as a tensor."""
    rng = np.random.default_rng(5)
    pts = rng.normal(0, 300, (50, 3)).astype(np.float32)
    pts[[3, 17, 40]] = np.nan
    cols = rng.integers(0, 256, (50, 3), dtype=np.uint8) if colors else None
    keep = rng.random(50) < 0.6 if valid else None
    n_want = jax_vis.save_ply(str(tmp_path / "jax.ply"), pts, cols, keep)
    n_got = vis.save_ply(str(tmp_path / "port.ply"), torch.from_numpy(pts),
                         None if cols is None else torch.from_numpy(cols),
                         keep)
    assert n_got == n_want
    with open(tmp_path / "jax.ply", "rb") as f, \
            open(tmp_path / "port.ply", "rb") as g:
        assert g.read() == f.read()
