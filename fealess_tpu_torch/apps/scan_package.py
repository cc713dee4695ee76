"""Scanner training-package loader and the offline training loop
(counterpart of ``fealess_tpu.apps.scan_package``).

Reimplements the reference's training data path (test/linemod_train.cpp):

- ``convert_raw_package``: raw scanner dumps -> png (``Convert``,
  linemod_train.cpp:93-144): ``depth/<i>.raw`` f32 is multiplied by 10 and
  stored as u16 png (0.1 mm units); ``gray/<i>.raw`` RGBA bytes become a
  BGR png.
- ``iter_training_frames``: per-frame load of gray/depth/pose/view
  (linemod_train.cpp:40-67): depth png x0.1 -> u16 mm, pose 3x4 row-major
  from ``pose/<i>.txt`` line 1, view distance from ``view/<i>.txt`` line 3,
  mask = pixels strictly nearer than ``depth[0, 0]`` (the background
  sentinel, linemod_train.cpp:59-67).
- ``train_package``: the ``linemod_train`` program (linemod_train.cpp:
  30-91): add a template per frame, write ``linemod_templates.yml``.
- ``load_scan_package``: the TLinemodPackage layout with GL projection,
  bounding box and optional mask pngs (linemod_train.cpp:180-255).

Frames are read by ``fealess_tpu_torch.io.imfile.read_image`` (PNG,
JPEG or BMP by content, as ``cv2.imread`` reads them) and written by
``fealess_tpu_torch.io.png``; no image library is needed.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from fealess_tpu_torch import config as cfg
from fealess_tpu_torch import training
from fealess_tpu_torch.bank import TemplateView
from fealess_tpu_torch.io import linemod_yaml
from fealess_tpu_torch.io.imfile import (IMREAD_COLOR, IMREAD_GRAYSCALE,
                                         IMREAD_UNCHANGED, DecodeError,
                                         read_image)
from fealess_tpu_torch.io.png import write_png

CHUNK = 32             # masked frames quantized per device call


def convert_raw_package(package_dir: str, width: int = 640,
                        height: int = 480, remove_raw: bool = True) -> int:
    """Convert ``depth/<i>.raw`` + ``gray/<i>.raw`` scanner dumps to png
    (Convert, linemod_train.cpp:93-144).  Returns the frame count."""
    i = 0
    while True:
        dsrc = os.path.join(package_dir, "depth", f"{i}.raw")
        gsrc = os.path.join(package_dir, "gray", f"{i}.raw")
        if not os.path.exists(dsrc):
            break
        depth = np.fromfile(dsrc, dtype=np.float32, count=width * height)
        depth = depth.reshape(height, width)
        depth_16u = np.clip(np.rint(depth * 10.0), 0, 65535).astype(np.uint16)
        write_png(os.path.join(package_dir, "depth", f"{i}.png"), depth_16u)

        if not os.path.exists(gsrc):
            break
        rgba = np.fromfile(gsrc, dtype=np.uint8,
                           count=width * height * 4).reshape(height, width, 4)
        write_png(os.path.join(package_dir, "gray", f"{i}.png"),
                  rgba[:, :, [2, 1, 0]].copy())
        if remove_raw:
            os.remove(dsrc)
            os.remove(gsrc)
        i += 1
    return i


def _load_array(path: str, n: int, line_idx: int = 0) -> Optional[np.ndarray]:
    """First ``n`` floats of line ``line_idx`` (LoadArray / LoadView,
    linemod_train.cpp:146-178)."""
    try:
        with open(path) as fh:
            lines = fh.readlines()
        vals = [float(v) for v in lines[line_idx].split()[:n]]
    except (OSError, IndexError, ValueError):
        return None
    if len(vals) < n:
        return None
    return np.asarray(vals, np.float32)


@dataclasses.dataclass
class TrainingFrame:
    index: int
    bgr: np.ndarray          # (H, W, 3) u8
    depth_mm: np.ndarray     # (H, W) u16 millimetres
    mask: Optional[np.ndarray]
    pose13: np.ndarray       # 3x4 world2cam row-major + view distance


def iter_training_frames(package_dir: str) -> Iterator[TrainingFrame]:
    """Yield frames in the reference's training layout until a file is
    missing or an image does not decode (linemod_train.cpp:40-67)."""
    i = 0
    while True:
        gray_p = os.path.join(package_dir, "gray", f"{i}.png")
        depth_p = os.path.join(package_dir, "depth", f"{i}.png")
        if not (os.path.isfile(gray_p) and os.path.isfile(depth_p)):
            return
        try:
            bgr = read_image(gray_p, IMREAD_COLOR)
            depth_raw = read_image(depth_p, IMREAD_UNCHANGED)
        except DecodeError:
            return
        # depth png is 0.1mm units; convertTo(CV_16U, 0.1) -> mm (cvRound)
        depth_mm = np.clip(np.rint(depth_raw.astype(np.float64) * 0.1),
                           0, 65535).astype(np.uint16)
        pose = _load_array(os.path.join(package_dir, "pose", f"{i}.txt"), 12)
        view = _load_array(os.path.join(package_dir, "view", f"{i}.txt"), 1,
                           line_idx=2)
        if pose is None or view is None:
            return
        pose13 = np.concatenate([pose, view]).astype(np.float32)
        # background sentinel mask (linemod_train.cpp:59-67)
        mask = depth_mm < depth_mm[0, 0]
        yield TrainingFrame(index=i, bgr=bgr, depth_mm=depth_mm,
                            mask=mask, pose13=pose13)
        i += 1


def train_package(package_dir: str, det: Optional[cfg.DetectorConfig] = None,
                  class_id: str = "obj",
                  out_yml: Optional[str] = None,
                  convert_raw: bool = True,
                  progress: bool = False,
                  device="cuda") -> Tuple[int, int]:
    """The linemod_train program: extract a template per frame on
    ``device`` and write the reference-schema database.  Masked frames go
    through :func:`training.add_templates_batched` in chunks of
    ``CHUNK``; frames without a usable mask take the single-view path.
    Returns (templates_added, frames_seen)."""
    det = det or cfg.DetectorConfig()
    if convert_raw:
        convert_raw_package(package_dir)
    views: List[TemplateView] = []
    frames = 0
    chunk: List[TrainingFrame] = []

    def flush():
        if not chunk:
            return
        results = training.add_templates_batched(
            [f.bgr for f in chunk], [f.depth_mm for f in chunk],
            [f.mask for f in chunk], [f.pose13 for f in chunk], det, device)
        for f, view in zip(chunk, results):
            if view is not None:
                views.append(view)
                if progress:
                    print(f"*** Added template (id {len(views) - 1}) from "
                          f"frame {f.index} ***")
            elif progress:
                print(f"Try adding template from frame {f.index} "
                      "but failed.")
        chunk.clear()

    for frame in iter_training_frames(package_dir):
        frames += 1
        if frame.mask is None or not np.any(frame.mask):
            flush()
            view = training.add_template(frame.bgr, frame.depth_mm,
                                         frame.mask, frame.pose13, det,
                                         device)
            if view is not None:
                views.append(view)
            continue
        chunk.append(frame)
        if len(chunk) >= CHUNK:
            flush()
    flush()
    out_yml = out_yml or os.path.join(package_dir, "linemod_templates.yml")
    linemod_yaml.save_linemod(out_yml, det, {class_id: views})
    return len(views), frames


@dataclasses.dataclass
class ScanPackage:
    """TLinemodPackage equivalent (linemod_train.cpp:19-24)."""
    obj_tag: str
    gl_projection: Optional[np.ndarray]     # (16,) or None
    bounding_box: Optional[np.ndarray]      # (6,) [x_min..z_max] or None
    frames: List[TrainingFrame]


def _read_mask(path: str) -> Optional[np.ndarray]:
    """``cv2.imread(path, IMREAD_GRAYSCALE) > 0``: PNG, JPEG or BMP, each
    converted to gray by its decoder's rule; None when the file is missing
    or does not decode."""
    if not os.path.isfile(path):
        return None
    try:
        return read_image(path, IMREAD_GRAYSCALE) > 0
    except DecodeError:
        return None


def load_scan_package(package_dir: str, obj_tag: str = "obj") -> ScanPackage:
    """LoadScanPackage (linemod_train.cpp:180-255): GL projection matrix,
    bounding box, and per-frame data (an optional ``mask/<i>.png``
    overrides the depth-sentinel mask)."""
    gl = _load_array(os.path.join(package_dir,
                                  "colorCameraGLProjection.txt"), 16)
    bbox = _load_array(os.path.join(package_dir, "volumeData.txt"), 6)
    frames = []
    for frame in iter_training_frames(package_dir):
        mask = _read_mask(os.path.join(package_dir, "mask",
                                       f"{frame.index}.png"))
        if mask is not None:
            frame = dataclasses.replace(frame, mask=mask)
        frames.append(frame)
    return ScanPackage(obj_tag=obj_tag, gl_projection=gl,
                       bounding_box=bbox, frames=frames)
