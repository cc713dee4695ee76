"""The port's I/O against OpenCV and the JAX package: the stdlib PNG reader
against ``cv2.imread``, the FileStorage YAML reader against
``fealess_tpu.io.linemod_yaml.load_linemod``, and a subprocess check that
the port runs a recognition without jax, flax or cv2."""

import json
import os
import struct
import subprocess
import sys
import zlib

import cv2
import numpy as np
import pytest
import torch

from fealess_tpu import config as cfg
from fealess_tpu.bank import TemplateView as JaxView
from fealess_tpu.io import linemod_yaml as jax_yaml
from fealess_tpu_torch.io import linemod_yaml as port_yaml
from fealess_tpu_torch.io.png import read_png

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "benchmarks", "reference", "out")


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _encode_png(img: np.ndarray, filters) -> bytes:
    """PNG bytes of a gray (H, W) or RGB (H, W, 3) u8/u16 image, row r
    filtered with ``filters[r % len(filters)]`` (0 None .. 4 Paeth)."""
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else 3
    depth = 16 if img.dtype == np.uint16 else 8
    raw = np.ascontiguousarray(img.astype(">u2" if depth == 16 else np.uint8))
    raw = raw.view(np.uint8).reshape(h, -1).astype(np.int64)
    bpp = ch * depth // 8
    rows = []
    prev = np.zeros(raw.shape[1], np.int64)
    for r in range(h):
        f = filters[r % len(filters)]
        x = raw[r]
        left = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if f == 0:
            pred = np.zeros_like(x)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        rows.append(bytes([f]) + ((x - pred) & 255).astype(np.uint8).tobytes())
        prev = x
    color = 0 if ch == 1 else 2
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + _chunk(b"IEND", b""))


@pytest.mark.parametrize("name", ["scene_bgr.png", "scene_depth.png",
                                  os.path.join("features", "depth", "0.png")])
def test_png_reader_matches_cv2_on_fixture(name):
    path = os.path.join(FIXTURE, name)
    got = read_png(path)
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4],
                                     [4, 3, 2, 1, 0]])
def test_png_reader_filter_types(tmp_path, filters):
    """Every filter type (and rows mixing them) on 8/16-bit gray and RGB,
    against cv2.imread of the same file."""
    rng = np.random.default_rng(11)
    images = [rng.integers(0, 256, (7, 9), dtype=np.uint8),
              rng.integers(0, 256, (6, 5, 3), dtype=np.uint8),
              rng.integers(0, 65536, (5, 8), dtype=np.uint16),
              rng.integers(0, 65536, (4, 6, 3), dtype=np.uint16)]
    for i, img in enumerate(images):
        path = str(tmp_path / f"img{i}.png")
        with open(path, "wb") as f:
            f.write(_encode_png(img, filters))
        got = read_png(path)
        want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        bgr = img if img.ndim == 2 else img[:, :, ::-1]
        np.testing.assert_array_equal(got, bgr)


def _assert_same_classes(port, ref):
    assert list(port.keys()) == list(ref.keys())
    for cname in ref:
        assert len(port[cname]) == len(ref[cname])
        for a, b in zip(port[cname], ref[cname]):
            assert (a.width, a.height, a.offset_x, a.offset_y) == \
                (b.width, b.height, b.offset_x, b.offset_y)
            assert a.pose.dtype == b.pose.dtype
            np.testing.assert_array_equal(a.pose, b.pose)
            for fl_a, fl_b in zip(a.features, b.features):
                for fa, fb in zip(fl_a, fl_b):
                    assert fa.dtype == fb.dtype and fa.shape == fb.shape
                    np.testing.assert_array_equal(fa, fb)


def test_load_linemod_fixture_equals_jax():
    path = os.path.join(FIXTURE, "features", "linemod_templates.yml")
    det_p, classes_p = port_yaml.load_linemod(path)
    det_j, classes_j = jax_yaml.load_linemod(path)
    assert det_p == det_j
    assert len(classes_p["obj"]) == 1024
    _assert_same_classes(classes_p, classes_j)


def test_load_linemod_roundtrip_of_save_linemod(tmp_path):
    """A database written by the JAX package's save_linemod (several
    classes, LINE and LINE-MOD modality sets, odd pose values) reads back
    identically through both loaders."""
    rng = np.random.default_rng(5)
    for det in (cfg.DetectorConfig(t_at_level=(5, 8, 4),
                                   depth_normal=cfg.DepthNormalConfig(
                                       distance_threshold=1500)),
                cfg.default_line()):
        n_mod = len(det.modalities)
        classes = {}
        for cname in ("b_cls", "a_cls", "c-3"):
            views = []
            for _ in range(int(rng.integers(1, 4))):
                feats = [[rng.integers(0, 200, (int(rng.integers(1, 20)), 3))
                          .astype(np.int32) for _ in range(n_mod)]
                         for _ in range(det.pyramid_levels)]
                views.append(JaxView(
                    features=feats,
                    width=[int(v) for v in rng.integers(10, 200,
                                                        det.pyramid_levels)],
                    height=[int(v) for v in rng.integers(10, 200,
                                                         det.pyramid_levels)],
                    offset_x=[int(v) for v in rng.integers(
                        0, 400, det.pyramid_levels)],
                    offset_y=[int(v) for v in rng.integers(
                        0, 300, det.pyramid_levels)],
                    pose=(rng.normal(size=13) * 100).astype(np.float32)))
            classes[cname] = views
        path = str(tmp_path / f"db_{n_mod}.yml")
        jax_yaml.save_linemod(path, det, classes)
        det_p, classes_p = port_yaml.load_linemod(path)
        det_j, classes_j = jax_yaml.load_linemod(path)
        assert det_p == det_j
        _assert_same_classes(classes_p, classes_j)


_SUBPROCESS = r"""
import json, sys
import numpy as np
from fealess_tpu import config as cfg
import fealess_tpu_torch
from fealess_tpu_torch.apps import fixture, profile_reco, track  # noqa: F401
from fealess_tpu_torch.engine import CamIntrinsics, ObjReco
from fealess_tpu_torch.tracker.kcf import KcfTracker

frame = np.load(sys.argv[2])
h, w = frame["depth"].shape
ecfg = cfg.EngineConfig(
    detector=cfg.DetectorConfig(image_width=w, image_height=h,
                                max_candidates=8),
    icp=cfg.IcpConfig(max_points=1024), refine_crop=64)
eng = ObjReco.create("LmICP", ecfg, device="cpu")
eng.add_obj(sys.argv[1])
cam = CamIntrinsics(608.0, 608.0, w / 2, h / 2, w, h)
res = eng.recognition(frame["bgr"], frame["depth"], cam)
multi = eng.recognition_multi(frame["bgr"], frame["depth"], cam,
                              max_objects=2)
kcf = KcfTracker(None)
_, roi = kcf.update(kcf.init((60, 20, 40, 40), frame["bgr"]), frame["bgr"])
print(json.dumps({"n": len(res), "n_multi": len(multi),
                  "roi_ok": bool(np.isfinite(roi).all()),
                  "loaded": [m for m in ("jax", "flax", "cv2")
                             if m in sys.modules]}))
"""


def test_port_runs_without_jax_flax_or_cv2(tmp_path):
    """A fresh interpreter imports the port (its apps included) and runs a
    small recognition, a multi-object recognition and a KCF update; jax,
    flax and cv2 must never be imported."""
    h, w = 80, 160
    rng = np.random.default_rng(2)
    bgr = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    depth = np.full((h, w), 700, np.uint16)
    feats = [[rng.integers(0, 40, (12, 3)).astype(np.int32) % [40, 40, 8]
              for _ in range(2)] for _ in range(2)]
    view = JaxView(features=feats, width=[40, 20], height=[40, 20],
                   offset_x=[30, 15], offset_y=[20, 10],
                   pose=np.eye(3, 4).reshape(-1).tolist() + [700.0])
    view.pose = np.asarray(view.pose, np.float32)
    feat_dir = tmp_path / "features"
    os.makedirs(feat_dir / "depth")
    jax_yaml.save_linemod(str(feat_dir / "linemod_templates.yml"),
                          cfg.DetectorConfig(image_width=w, image_height=h),
                          {"obj": [view]})
    cv2.imwrite(str(feat_dir / "depth" / "0.png"),
                (depth.astype(np.uint32) * 10).astype(np.uint16))
    frame = str(tmp_path / "frame.npz")
    np.savez(frame, bgr=bgr, depth=depth)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _SUBPROCESS, str(feat_dir),
                          frame], capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["loaded"] == []
    assert result["n"] in (0, 1)
    assert result["n_multi"] in (0, 1, 2) and result["roi_ok"]
