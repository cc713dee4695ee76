"""KCF-gated recognition (counterpart of ``fealess_tpu.apps.track``): track
the object ROI between frames and gate LINE-MOD re-detection to the tracked
region.

The reference's tracking demo (test/linemod_acq.cpp:103-196): a KCF tracker
propagates the object ROI frame to frame; each frame the (expanded) ROI
gates ``Detector::match`` and the match re-centres the tracker.  Full-frame
re-detection runs on the first frame and whenever the gated match loses
the object for ``max_lost`` consecutive frames.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from fealess_tpu import config as cfg
from fealess_tpu_torch import pipeline
from fealess_tpu_torch.engine import CamIntrinsics, ObjReco, RecoResult
from fealess_tpu_torch.tracker.kcf import KcfTracker


def roi_box(roi: torch.Tensor, expand: float) -> torch.Tensor:
    """The (x0, y0, x1, y1) candidate gate (detector ``roi_box``) of an
    (x, y, w, h) ROI grown by ``expand`` about its centre."""
    x, y, rw, rh = roi.unbind()
    ex_f = (expand - 1.0) / 2.0
    ex, ey = ex_f * rw, ex_f * rh
    return torch.stack([x - ex, y - ey, x + rw + ex, y + rh + ey])


@dataclasses.dataclass
class TrackStep:
    """Per-frame outcome of the gated pipeline."""
    results: List[RecoResult]
    roi: Optional[Tuple[float, float, float, float]]   # (x, y, w, h) or None
    redetected: bool          # this frame ran a full-frame match
    tracking: bool            # a KCF state is live after this frame


class TrackedRecognizer:
    """KCF-gated recognition over a frame stream on the engine's device.

    The engine's processing resolution must equal the camera resolution
    (zoom == 1), so tracker ROIs and match coordinates share one frame.
    """

    def __init__(self, engine: ObjReco, kcf: Optional[cfg.KcfConfig] = None,
                 roi_expand: float = 1.4, max_lost: int = 2):
        self.engine = engine
        self.kcf_cfg = kcf
        self.roi_expand = roi_expand
        self.max_lost = max_lost
        self._tracker: Optional[KcfTracker] = None
        self._state = None
        self._lost = 0

    def reset(self) -> None:
        self._tracker = None
        self._state = None
        self._lost = 0

    def _gated_step(self, bgr: np.ndarray, depth_u16: np.ndarray,
                    cam: CamIntrinsics):
        """KCF update -> ROI box -> box-gated top-1 match and refine, all on
        the device; the frame's ROI and result come back in ONE transfer
        (besides ICP's own loop checks)."""
        eng = self.engine
        bgr_d, depth_d, scene_k = eng._prepare_frame(bgr, depth_u16, cam)
        batch, _ = self._tracker._update(
            KcfTracker.stack_states([self._state]),
            bgr_d[:bgr.shape[0], :bgr.shape[1]])
        st = KcfTracker.unstack_states(batch)[0]
        # a positional gate on the candidates, as the JAX version
        step = pipeline.recognize_top1(
            eng.bank, eng._model_depth_dev, eng._origins_dev, bgr_d, depth_d,
            scene_k, eng.cfg, kernels=eng._kernels,
            roi_box=roi_box(st.roi, self.roi_expand))
        results, roi = eng._fetch_top1(step, extra=st.roi)
        return st, results, tuple(float(v) for v in roi)

    def step(self, bgr: np.ndarray, depth_u16: np.ndarray,
             cam: CamIntrinsics) -> TrackStep:
        """Process one frame: track -> gated match -> (re)init."""
        d = self.engine.cfg.detector
        if cam.width != d.image_width:
            raise ValueError("gated tracking requires zoom == 1 "
                             f"(camera {cam.width} vs processing "
                             f"{d.image_width})")
        redetect = self._state is None
        roi = None
        if not redetect:
            self._state, results, roi = self._gated_step(bgr, depth_u16, cam)
            if not results:
                self._lost += 1
                if self._lost >= self.max_lost:
                    self.reset()
                    redetect = True
            else:
                self._lost = 0
        if redetect:
            results = self.engine.recognition(bgr, depth_u16, cam)
            if results:
                roi = results[0].match_rect
                self._tracker = KcfTracker(self.kcf_cfg, self.engine.device)
                self._state = self._tracker.init(roi, bgr)
                self._lost = 0
            else:
                roi = None
                self.reset()
        return TrackStep(results=results, roi=roi, redetected=redetect,
                         tracking=self._state is not None)


@dataclasses.dataclass
class MultiTrackStep:
    """Per-frame outcome of the N-object gated pipeline."""
    results: List[RecoResult]                 # associated, one per object
    rois: List[Tuple[float, float, float, float]]
    redetected: bool
    n_tracked: int


class _TrackedObject:
    __slots__ = ("tracker", "state", "lost")

    def __init__(self, tracker, state):
        self.tracker = tracker
        self.state = state
        self.lost = 0


def _roi_tuple(roi: torch.Tensor) -> Tuple[float, ...]:
    return tuple(float(v) for v in roi.cpu().numpy())


class MultiTrackedRecognizer:
    """N-object KCF-gated recognition.

    Trackers that share a patch geometry (the same ``_fit_template``
    output: objects of similar ROI size) form one bucket and update as ONE
    batched call per bucket; detection is a single union-ROI-masked
    ``recognition_multi`` (top-M refine + 3D NMS) per frame, and results
    associate to tracked objects by ROI-centre distance.  Full-frame
    re-detection runs when no object is tracked.
    """

    def __init__(self, engine: ObjReco, kcf: Optional[cfg.KcfConfig] = None,
                 roi_expand: float = 1.4, max_lost: int = 2,
                 max_objects: Optional[int] = None):
        self.engine = engine
        self.kcf_cfg = kcf
        self.roi_expand = roi_expand
        self.max_lost = max_lost
        self.max_objects = max_objects or engine.cfg.max_objects
        self._objs: List[_TrackedObject] = []
        self._trackers = {}     # geometry key -> shared KcfTracker

    def reset(self) -> None:
        self._objs = []
        self._trackers = {}

    def _tracker_for(self, roi) -> KcfTracker:
        probe = KcfTracker(self.kcf_cfg, self.engine.device)
        key = probe._fit_template(float(roi[2]), float(roi[3]))
        if key not in self._trackers:
            self._trackers[key] = probe
        return self._trackers[key]

    def _expand(self, roi):
        x, y, w, h = roi
        e = (self.roi_expand - 1.0) / 2.0
        return (x - e * w, y - e * h, w * self.roi_expand,
                h * self.roi_expand)

    def _union_mask(self, shape_hw, rois) -> np.ndarray:
        mask = np.zeros(shape_hw, bool)
        for roi in rois:
            x, y, w, h = self._expand(roi)
            x0, y0 = max(int(x), 0), max(int(y), 0)
            x1 = min(int(x + w), shape_hw[1])
            y1 = min(int(y + h), shape_hw[0])
            mask[y0:y1, x0:x1] = True
        return mask

    def _detect_and_init(self, bgr, depth_u16, cam) -> List[RecoResult]:
        results = self.engine.recognition_multi(
            bgr, depth_u16, cam, max_objects=self.max_objects)
        self._objs = []
        for r in results:
            tr = self._tracker_for(r.match_rect)
            self._objs.append(_TrackedObject(tr, tr.init(r.match_rect, bgr)))
        return results

    def step(self, bgr: np.ndarray, depth_u16: np.ndarray,
             cam: CamIntrinsics) -> MultiTrackStep:
        d = self.engine.cfg.detector
        if cam.width != d.image_width:
            raise ValueError("gated tracking requires zoom == 1")
        if not self._objs:
            results = self._detect_and_init(bgr, depth_u16, cam)
            return MultiTrackStep(
                results=results,
                rois=[_roi_tuple(o.state.roi) for o in self._objs],
                redetected=True, n_tracked=len(self._objs))

        # 1. one batched KCF update per geometry bucket, one ROI fetch each
        image = torch.from_numpy(np.ascontiguousarray(bgr)).to(
            self.engine.device)
        by_tracker = {}
        for i, o in enumerate(self._objs):
            by_tracker.setdefault(id(o.tracker), (o.tracker, []))[1].append(i)
        rois = [None] * len(self._objs)
        for tracker, idxs in by_tracker.values():
            batch = tracker.update_batch(KcfTracker.stack_states(
                [self._objs[i].state for i in idxs]), image)
            rois_np = batch.roi.cpu().numpy()
            for j, (i, st) in enumerate(zip(idxs,
                                            KcfTracker.unstack_states(batch))):
                self._objs[i].state = st
                rois[i] = tuple(float(v) for v in rois_np[j])

        # 2. one union-masked multi-object recognition
        results = self.engine.recognition_multi(
            bgr, depth_u16, cam, max_objects=self.max_objects,
            roi_mask=self._union_mask(bgr.shape[:2], rois))

        # 3. associate by ROI-centre distance
        centers = [(r.match_rect[0] + r.match_rect[2] / 2,
                    r.match_rect[1] + r.match_rect[3] / 2) for r in results]
        taken = [False] * len(results)
        assoc: List[Optional[RecoResult]] = [None] * len(self._objs)
        for i, roi in enumerate(rois):
            cx, cy = roi[0] + roi[2] / 2, roi[1] + roi[3] / 2
            best, best_d = -1, max(roi[2], roi[3])
            for j, (mx, my) in enumerate(centers):
                if taken[j]:
                    continue
                dd = ((mx - cx) ** 2 + (my - cy) ** 2) ** 0.5
                if dd < best_d:
                    best, best_d = j, dd
            if best >= 0:
                taken[best] = True
                assoc[i] = results[best]
                self._objs[i].lost = 0
            else:
                self._objs[i].lost += 1

        # 4. drop lost objects; full re-detect when none remain
        survivors = [i for i, o in enumerate(self._objs)
                     if o.lost < self.max_lost]
        redetected = False
        if not survivors:
            self.reset()
            assoc = list(self._detect_and_init(bgr, depth_u16, cam))
            rois = [_roi_tuple(o.state.roi) for o in self._objs]
            redetected = True
        else:
            self._objs = [self._objs[i] for i in survivors]
            assoc = [assoc[i] for i in survivors]
            rois = [rois[i] for i in survivors]
        return MultiTrackStep(
            results=[a for a in assoc if a is not None],
            rois=rois, redetected=redetected, n_tracked=len(self._objs))
