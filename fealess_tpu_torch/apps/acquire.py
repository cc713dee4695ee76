"""Frame acquisition and ROI selection tools (counterpart of
``fealess_tpu.apps.acquire``).

- ``acquire_series``: the capture/dump tool ``linemod_acq``
  (test/linemod_acq.cpp:10-102).  It writes ``gray/<i>.png``,
  ``depth/<i>.png`` and optionally a ``cloud/<i>.txt`` point dump (mm)
  per saved frame into the scan-package layout that ``train``, ``recon``
  and ``track`` read, printing the intrinsics.  Frames come from
  ``io.series.ImageSeriesReader`` (a directory or a list of PNG files;
  cameras, video files and JPEG/BMP need cv2 and are refused there),
  paired with an optional depth directory, and are written with
  ``io/png.write_png``.
- ``BoxExtractor``: the interactive ROI picker
  (kcf_tracker/BoxExtractor.{h,cpp}).  It needs a display and cv2's
  ``selectROI``, and raises ``RuntimeError`` without either, as the JAX
  package's does without a display; :func:`roi_from_mask` and
  :func:`roi_from_depth` are the headless equivalents.
"""

from __future__ import annotations

import glob
import os
import sys
from typing import Optional, Tuple

import numpy as np

Roi = Tuple[float, float, float, float]          # x, y, w, h


def roi_from_mask(mask: np.ndarray, pad: int = 0) -> Optional[Roi]:
    """Tight bounding box of the nonzero pixels of ``mask`` (+``pad`` px),
    or None when the mask is empty (the programmatic stand-in for
    BoxExtractor's mouse rectangle)."""
    ys, xs = np.nonzero(np.asarray(mask))
    if len(xs) == 0:
        return None
    h, w = mask.shape[:2]
    x0 = max(int(xs.min()) - pad, 0)
    y0 = max(int(ys.min()) - pad, 0)
    x1 = min(int(xs.max()) + pad, w - 1)
    y1 = min(int(ys.max()) + pad, h - 1)
    return (float(x0), float(y0), float(x1 - x0 + 1), float(y1 - y0 + 1))


def roi_from_depth(depth_mm: np.ndarray, max_depth_mm: float = 900.0,
                   pad: int = 8) -> Optional[Roi]:
    """ROI of the nearest depth blob: pixels valid and within
    ``max_depth_mm`` (the is_vec3f_valid cap, ICP/common.cpp:261-266)."""
    d = np.asarray(depth_mm)
    return roi_from_mask((d > 0) & (d <= max_depth_mm), pad=pad)


class BoxExtractor:
    """Interactive ROI selection (kcf_tracker/BoxExtractor.h:21-37)."""

    def extract(self, window_name: str, image: np.ndarray) -> Roi:
        """The rectangle dragged in an OpenCV window; raises RuntimeError
        without a display or without cv2 (use :func:`roi_from_mask` /
        :func:`roi_from_depth` headless)."""
        has_display = (os.environ.get("DISPLAY")
                       or os.environ.get("WAYLAND_DISPLAY")
                       or os.name == "nt" or sys.platform == "darwin")
        if not has_display:
            raise RuntimeError(
                "BoxExtractor.extract needs a display; use roi_from_mask / "
                "roi_from_depth for headless ROI selection")
        try:
            import cv2
        except ImportError as e:
            raise RuntimeError(
                "BoxExtractor.extract needs cv2's selectROI, which is not "
                "installed; use roi_from_mask / roi_from_depth for headless "
                "ROI selection") from e
        try:
            x, y, w, h = cv2.selectROI(window_name, image,
                                       showCrosshair=True)
        except cv2.error as e:
            raise RuntimeError(
                "BoxExtractor.extract could not open a window "
                f"({e}); use roi_from_mask / roi_from_depth for headless "
                "ROI selection") from e
        cv2.destroyWindow(window_name)
        return (float(x), float(y), float(w), float(h))


def write_cloud_txt(path: str, points_m: np.ndarray,
                    valid: Optional[np.ndarray] = None) -> int:
    """Dump a point cloud as whitespace ``x y z`` rows in millimetres (the
    x1000 scaling of linemod_acq.cpp's cloud txt dump).  Returns the
    number of points written."""
    pts = np.asarray(points_m, np.float32).reshape(-1, 3)
    if valid is not None:
        pts = pts[np.asarray(valid).reshape(-1)]
    pts = pts[np.isfinite(pts).all(axis=1)] * 1000.0
    with open(path, "w") as f:
        for p in pts:
            f.write(f"{p[0]:.3f} {p[1]:.3f} {p[2]:.3f}\n")
    return len(pts)


def acquire_series(color_source, out_dir: str,
                   depth_dir: Optional[str] = None,
                   fx: float = 608.0, fy: float = 608.0,
                   cx: float = 320.0, cy: float = 240.0,
                   max_frames: Optional[int] = None,
                   save_clouds: bool = False,
                   target_wh: Tuple[int, int] = (640, 480)) -> int:
    """Capture frames into the scan-package layout (linemod_acq.cpp:10-102):
    ``gray/<i>.png`` (colour resized to ``target_wh``), ``depth/<i>.png``
    (u16 mm as read, when a depth series is given) and optionally
    ``cloud/<i>.txt`` (mm, back-projected on the CPU).  Depth pairs with
    colour by file stem.  Returns the number of frames saved."""
    import torch

    from fealess_tpu_torch.geometry import depth as gd
    from fealess_tpu_torch.io.png import DecodeError, read_png, write_png
    from fealess_tpu_torch.io.series import ImageSeriesReader, \
        numeric_stem_key

    reader = ImageSeriesReader(color_source, target_wh=target_wh)
    os.makedirs(os.path.join(out_dir, "gray"), exist_ok=True)
    # gray/7.png pairs with depth/7.png by stem, never by position: an
    # unreadable colour file would shift every later pair
    depth_by_stem = {}
    if depth_dir:
        os.makedirs(os.path.join(out_dir, "depth"), exist_ok=True)
        depth_list = sorted(glob.glob(os.path.join(depth_dir, "*.png")),
                            key=numeric_stem_key)
        depth_by_stem = {os.path.splitext(os.path.basename(p))[0]: p
                         for p in depth_list}
    if save_clouds:
        os.makedirs(os.path.join(out_dir, "cloud"), exist_ok=True)

    print(f"intrinsics: fx={fx} fy={fy} cx={cx} cy={cy} "
          f"size={target_wh[0]}x{target_wh[1]}")
    k = gd.intrinsics_matrix(fx, fy, cx, cy, device="cpu")
    n = 0
    for i, (stem, frame) in enumerate(reader.iter_named()):
        if max_frames is not None and n >= max_frames:
            break
        write_png(os.path.join(out_dir, "gray", f"{i}.png"), frame)
        depth_path = depth_by_stem.get(stem)
        if depth_path is not None:
            try:
                d = read_png(depth_path).astype(np.uint16)
            except DecodeError:                      # cv2.imread: None
                d = None
            if d is not None:
                write_png(os.path.join(out_dir, "depth", f"{i}.png"), d)
                if save_clouds:
                    pts = gd.depth_to_3d(
                        torch.from_numpy(d.astype(np.int32)), k).numpy()
                    write_cloud_txt(
                        os.path.join(out_dir, "cloud", f"{i}.txt"), pts)
        n += 1
    print(f"saved {n} frames to {out_dir}")
    return n
