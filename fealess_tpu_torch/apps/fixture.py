"""The in-repo fixture (``benchmarks/reference/out``: 1024 templates, a
640x480 RGB-D scene, K = 608 608 320 240) and the scenes that
``chip_smoke.py`` and ``profile_reco`` build from it."""

from __future__ import annotations

import os

import numpy as np

from fealess_tpu_torch.engine import CamIntrinsics, ObjReco
from fealess_tpu_torch.io.png import read_png

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FIXTURE = os.path.join(REPO, "benchmarks", "reference", "out")
# the object's rect in the scene, and where the two-instance scene pastes
# a second copy of it
RECT = (237, 157, 191, 159)
PASTE = (20, 57)


def load(device):
    """(engine with the fixture's bank added, bgr, depth, cam)."""
    eng = ObjReco.create("LmICP", device=device)
    eng.add_obj(os.path.join(FIXTURE, "features"))
    bgr = read_png(os.path.join(FIXTURE, "scene_bgr.png"))
    depth = read_png(os.path.join(FIXTURE, "scene_depth.png"))
    with open(os.path.join(FIXTURE, "cam.txt")) as f:
        fx, fy, cx, cy = (float(v) for v in f.read().split())
    return eng, bgr, depth, CamIntrinsics(fx, fy, cx, cy, depth.shape[1],
                                          depth.shape[0])


def two_instance_scene(bgr: np.ndarray, depth: np.ndarray):
    """The scene with its object rect (colour and depth) pasted a second
    time at ``PASTE``."""
    x0, y0, w, h = RECT
    x, y = PASTE
    bgr2, depth2 = bgr.copy(), depth.copy()
    bgr2[y:y + h, x:x + w] = bgr[y0:y0 + h, x0:x0 + w]
    depth2[y:y + h, x:x + w] = depth[y0:y0 + h, x0:x0 + w]
    return bgr2, depth2


def pan(bgr: np.ndarray, depth: np.ndarray, n: int):
    """``n`` frames; frame i is the scene rolled by 2i columns and i
    rows."""
    return [(np.roll(np.roll(bgr, i, 0), 2 * i, 1),
             np.roll(np.roll(depth, i, 0), 2 * i, 1)) for i in range(n)]
