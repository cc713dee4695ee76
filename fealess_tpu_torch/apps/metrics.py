"""Pose-accuracy metrics and evaluation harness (the port's own copy of
``fealess_tpu.apps.metrics``, read by ``cli eval``).

The reference has NO quantitative evaluation (its only signal is timing
prints + visual overlays, SURVEY.md §4/§6); these are the standard 6DoF
metrics the framework's baseline is defined in (BASELINE.md):

- ADD: mean distance between model points under estimated vs ground-truth
  pose (Hinterstoisser et al.); pass if < ``tau * diameter``.
- rotation geodesic error (deg), translation L2 error (mm).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class PoseErrors:
    add: float                 # mean point distance (model units, mm)
    rot_deg: float
    trans_mm: float


@dataclasses.dataclass
class EvalSummary:
    n_frames: int
    n_detected: int
    add_pass_rate: float       # over ALL frames (missed detection = fail)
    detection_rate: float
    mean_add: float            # over detected frames
    mean_rot_deg: float
    mean_trans_mm: float
    errors: List[Optional[PoseErrors]]


def pose_errors(pose_est: np.ndarray, pose_gt: np.ndarray,
                model_points: np.ndarray) -> PoseErrors:
    """Errors between two 4x4 world2cam poses over a model point set."""
    r1, t1 = pose_est[:3, :3], pose_est[:3, 3]
    r2, t2 = pose_gt[:3, :3], pose_gt[:3, 3]
    p1 = model_points @ r1.T + t1
    p2 = model_points @ r2.T + t2
    add = float(np.linalg.norm(p1 - p2, axis=1).mean())
    cos = (np.trace(r1.T @ r2) - 1.0) / 2.0
    rot = float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))
    trans = float(np.linalg.norm(t1 - t2))
    return PoseErrors(add=add, rot_deg=rot, trans_mm=trans)


def model_diameter(model_points: np.ndarray) -> float:
    """Max pairwise extent (approximated by the bbox diagonal for large
    clouds; exact for <= 2000 points)."""
    pts = np.asarray(model_points, np.float32)
    if len(pts) <= 2000:
        d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
        return float(np.sqrt(d2.max()))
    return float(np.linalg.norm(pts.max(0) - pts.min(0)))


def evaluate(poses_est: Sequence[Optional[np.ndarray]],
             poses_gt: Sequence[np.ndarray],
             model_points: np.ndarray,
             add_tau: float = 0.1) -> EvalSummary:
    """ADD pass-rate evaluation over a frame series.

    ``poses_est[i]`` is None when frame ``i`` had no detection (counts as
    a failure).  Pass threshold = ``add_tau * model_diameter`` (the
    conventional tau = 0.1)."""
    diam = model_diameter(model_points)
    errors: List[Optional[PoseErrors]] = []
    passed = 0
    det = 0
    for est, gt in zip(poses_est, poses_gt):
        if est is None:
            errors.append(None)
            continue
        det += 1
        e = pose_errors(np.asarray(est), np.asarray(gt), model_points)
        errors.append(e)
        if e.add < add_tau * diam:
            passed += 1
    n = len(poses_gt)
    dets = [e for e in errors if e is not None]
    return EvalSummary(
        n_frames=n, n_detected=det,
        add_pass_rate=passed / n if n else 0.0,
        detection_rate=det / n if n else 0.0,
        mean_add=float(np.mean([e.add for e in dets])) if dets else np.inf,
        mean_rot_deg=float(np.mean([e.rot_deg for e in dets]))
        if dets else np.inf,
        mean_trans_mm=float(np.mean([e.trans_mm for e in dets]))
        if dets else np.inf,
        errors=errors)
