"""The product engine API: the ObjReco facade (counterpart of
``fealess_tpu.engine``).

Mirrors ``CObjRecoLmICP`` (CadReco/obj_reco_lmicp.cpp:47-348): create an
engine on a device, ``add_obj`` a trained feature directory
(``linemod_templates.yml`` + ``depth/<tid>.png`` model depths), then
``recognition`` (top-1) or ``recognition_multi`` (top-M + 3D NMS) on RGB-D
frames, which return world2cam poses.  The bank,
its score tables and the model depth stack are uploaded to the engine's
device once per ``add_obj``; a frame is uploaded, matched and refined
there, and the result comes back in one transfer.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np
import torch

from fealess_tpu_torch import config as cfg
from fealess_tpu_torch import detector as det_mod
from fealess_tpu_torch import pipeline
from fealess_tpu_torch.bank import TemplateBank, class_slot_mask, pack_bank
from fealess_tpu_torch.geometry import depth as gd
from fealess_tpu_torch.geometry import pnp
from fealess_tpu_torch.io import linemod_yaml
from fealess_tpu_torch.io.png import read_png
from fealess_tpu_torch.ops import resize
from fealess_tpu_torch.utils.logging import get_logger

# Error codes (CadReco/lotus_common.h:5-10)
ERROR_INVALID_PARAM = 0x80000001
ERROR_OPEN_FILE_FAILED = 0x80000002


@dataclasses.dataclass
class CamIntrinsics:
    """TCamIntrinsicParam equivalent (lotus_common.h:24-35)."""
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int


@dataclasses.dataclass
class RecoResult:
    """TObjRecoResult equivalent (lotus_common.h:95-100), plus the match
    rect (x, y, w, h) at processing resolution."""
    obj_tag: str
    world2cam: np.ndarray          # 4x4 row-major
    similarity: float
    icp_dist: float
    inlier_ratio: float
    match_rect: Optional[tuple] = None


class ObjReco:
    """LmICP recognition engine (CObjRecoLmICP) on one torch device."""

    def __init__(self, engine_cfg: Optional[cfg.EngineConfig] = None,
                 device="cuda"):
        self.cfg = engine_cfg or cfg.EngineConfig()
        self.device = torch.device(device)
        self.bank: Optional[TemplateBank] = None
        # per-object state; clear_obj() is the single reset point
        self._kernels = None
        self._model_depth_dev = None                     # (N, CROP, CROP) mm
        self._origins_dev = None
        self._depth_origin: dict = {}                    # slot -> crop origin
        self._rect_wh: Optional[np.ndarray] = None       # (N, 2) level-0 w, h
        self._feature_path = ""

    # -- factory (CObjRecoCAD::Create, obj_reco_temp.cpp:13-30)
    @staticmethod
    def create(algorithm: str = "LmICP",
               engine_cfg: Optional[cfg.EngineConfig] = None,
               device="cuda") -> "ObjReco":
        if algorithm != "LmICP":
            raise NotImplementedError(
                f"algorithm {algorithm!r} not implemented (reference "
                "implements only LmICP, obj_reco_temp.cpp:13-30)")
        return ObjReco(engine_cfg, device)

    @staticmethod
    def get_version() -> str:
        return "fealess-tpu-torch-0.1.0"

    def clear_obj(self) -> None:
        """Drop the loaded bank and every per-object cache."""
        self.bank = None
        self._kernels = None
        self._model_depth_dev = None
        self._origins_dev = None
        self._depth_origin = {}
        self._rect_wh = None
        self._feature_path = ""

    def add_obj(self, feature_path: str) -> None:
        """Load ``<dir>/linemod_templates.yml`` and the per-template model
        depths ``<dir>/depth/<tid>.png`` (AddObj, obj_reco_lmicp.cpp:67-74,
        156-188), replacing any loaded object."""
        self.clear_obj()
        self._feature_path = feature_path
        yml = os.path.join(feature_path, "linemod_templates.yml")
        det_cfg, classes = linemod_yaml.load_linemod(yml)
        det_cfg = dataclasses.replace(
            det_cfg,
            image_width=self.cfg.detector.image_width,
            image_height=self.cfg.detector.image_height,
            max_candidates=self.cfg.detector.max_candidates,
            max_features=self.cfg.detector.max_features,
            max_templates=self.cfg.detector.max_templates)
        self.cfg = dataclasses.replace(self.cfg, detector=det_cfg)
        n_real = sum(len(v) for v in classes.values())
        if n_real == 0:
            raise IOError(f"no classes in {yml}")
        # capacity rounded up to 8 slots, as the JAX engine sizes its bank
        cap = min(self.cfg.detector.max_templates, -(-n_real // 8) * 8)
        self.bank = pack_bank(classes, levels=det_cfg.pyramid_levels,
                              modalities=len(det_cfg.modalities),
                              capacity=cap, max_features=det_cfg.max_features,
                              device=self.device)
        self._rect_wh = torch.stack([self.bank.width[:, 0],
                                     self.bank.height[:, 0]], 1).cpu().numpy()
        self._kernels = det_mod.build_match_tables(self.bank,
                                                   self.cfg.detector)
        self._load_model_depths(classes)

    def _model_depth_path(self, cname: str, tid: int,
                          multi_class: bool) -> str:
        """``depth/<class>/<tid>.png`` for multi-class banks (or when it
        exists), else the reference's flat ``depth/<tid>.png``."""
        qualified = os.path.join(self._feature_path, "depth", cname,
                                 f"{tid}.png")
        if multi_class or os.path.exists(qualified):
            return qualified
        return os.path.join(self._feature_path, "depth", f"{tid}.png")

    def _load_model_depths(self, classes) -> None:
        """Crop each template's model depth (0.1 mm PNG) to the refine
        window at its rect origin, in mm (x model_depth_scale, rounded half
        to even as cv::convertTo), and upload the stack to the device."""
        n = self.bank.capacity
        crop = self.cfg.refine_crop
        out = np.zeros((n, crop, crop), np.int32)
        multi_class = len(classes) > 1
        slot = 0
        missing: List[str] = []
        for cname in sorted(classes.keys()):
            for tid, view in enumerate(classes[cname]):
                path = self._model_depth_path(cname, tid, multi_class)
                if not os.path.isfile(path):
                    missing.append(path)
                    slot += 1
                    continue
                img = read_png(path)
                if img.ndim != 2:
                    raise IOError(f"model depth {path} is not single-channel "
                                  f"(shape {img.shape})")
                x0 = max(int(view.offset_x[0]), 0)
                y0 = max(int(view.offset_y[0]), 0)
                if img.shape[0] <= y0 or img.shape[1] <= x0:
                    raise IOError(
                        f"model depth {path} ({img.shape[1]}x{img.shape[0]})"
                        f" does not cover template rect origin ({x0}, {y0})")
                mm = img.astype(np.float32) * self.cfg.model_depth_scale
                mm16 = np.rint(mm).astype(np.uint16)
                win = mm16[y0:y0 + crop, x0:x0 + crop]
                out[slot, :win.shape[0], :win.shape[1]] = win
                self._depth_origin[slot] = (x0, y0)
                slot += 1
        if missing:
            raise IOError(f"{len(missing)} model depth png(s) missing, e.g. "
                          f"{missing[0]}")
        get_logger().debug("loaded %d model depths", slot)
        self._model_depth_dev = torch.from_numpy(out).to(self.device)
        self._origins_dev = torch.from_numpy(self._origins_array()).to(
            self.device)

    def set_roi(self, roi_mask: np.ndarray) -> None:
        """SetROI is a stub in the reference (obj_reco_lmicp.cpp:81-84);
        pass ``roi_mask`` to :meth:`recognition` instead."""

    def export_artifact(self, path: str) -> None:
        """Write the serving artifact (``fealess_tpu_torch.io.export``):
        the engine state that a fresh process serves from without parsing
        the YAML bank or decoding the model depth PNGs."""
        from fealess_tpu_torch.io import export as export_mod
        export_mod.export_artifact(self, path)

    # -- advanced params (stubs in the reference, obj_reco_lmicp.cpp:
    # 206-214; here they reconfigure)
    _PARAM_PATHS = {
        "matching_threshold": ("matching_threshold",),
        "icp_iterations": ("icp", "max_iterations"),
        "icp_dist_mean_threshold": ("icp", "dist_mean_threshold"),
        "icp_dist_diff_threshold": ("icp", "dist_diff_threshold"),
        "icp_mode": ("icp", "mode"),
        "max_objects": ("max_objects",),
        "nms_object_distance": ("nms_object_distance",),
    }

    def set_advanced_param(self, name: str, value) -> None:
        path = self._PARAM_PATHS.get(name)
        if path is None:
            raise KeyError(f"unknown advanced param {name!r}; "
                           f"known: {sorted(self._PARAM_PATHS)}")
        if len(path) == 1:
            self.cfg = dataclasses.replace(self.cfg, **{path[0]: value})
        else:
            sub = dataclasses.replace(getattr(self.cfg, path[0]),
                                      **{path[1]: value})
            self.cfg = dataclasses.replace(self.cfg, **{path[0]: sub})

    def get_advanced_param(self, name: str):
        obj = self.cfg
        for p in self._PARAM_PATHS[name]:
            obj = getattr(obj, p)
        return obj

    def compute_pose_epnp(self, model_depth_raw: np.ndarray,
                          match_x: int, match_y: int,
                          pose_init_4x4: np.ndarray,
                          cam: CamIntrinsics) -> Optional[np.ndarray]:
        """The reference's dormant EPnP pose path (``ComputePose`` behind
        EPNP_LM, obj_reco_lmicp.cpp:275-348): back-project the template's
        masked depth pixels (below the sentinel ``raw[0, 0]``, at least 10
        mm) into the model frame with the initial pose, pair them with
        their scene pixels at the match offset, and solve EPnP
        (``geometry.pnp``, OpenCV's EPnP in float64 on the host).
        ``model_depth_raw`` is the stored 0.1 mm u16 PNG.  Returns the
        float32 4x4 world2cam pose, or None below 4 points."""
        raw = np.asarray(model_depth_raw)
        sentinel = raw[0, 0]
        ii, jj = np.nonzero(raw < sentinel)
        z = raw[ii, jj].astype(np.float32) * self.cfg.model_depth_scale
        ok = z >= 10.0                      # EFFECTIVE_DEPTH gate
        ii, jj, z = ii[ok], jj[ok], z[ok]
        if len(z) < 4:
            return None
        k = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy],
                      [0, 0, 1]], np.float64)
        pix = np.stack([jj, ii, np.ones_like(jj)], axis=0).astype(np.float64)
        xc = (np.linalg.inv(k) @ pix) * z[None, :]
        r = np.asarray(pose_init_4x4, np.float64)[:3, :3]
        t = np.asarray(pose_init_4x4, np.float64)[:3, 3]
        xw = (r.T @ (xc - t[:, None])).T.astype(np.float32)
        img_pts = np.stack([jj + match_x, ii + match_y],
                           axis=-1).astype(np.float32)
        _, rvec, tvec = pnp.solve_pnp_epnp(xw, img_pts, k)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = pnp.rodrigues(rvec)
        pose[:3, 3] = tvec[:, 0]
        return pose

    def _origins_array(self) -> np.ndarray:
        out = np.zeros((self.bank.capacity, 2), np.int32)
        out[:, 0] = self.bank.offset_x[:, 0].cpu().numpy()
        out[:, 1] = self.bank.offset_y[:, 0].cpu().numpy()
        for slot, (x0, y0) in self._depth_origin.items():
            out[slot] = (x0, y0)
        return out

    def _prepare_frame(self, rgb_bgr: np.ndarray, depth_u16: np.ndarray,
                       cam: CamIntrinsics):
        """PrepareInputData (obj_reco_lmicp.cpp:216-259): resize to the
        processing width and zoom the intrinsics, then pad bottom/right to
        the pyramid alignment (zero colour, zero = invalid depth) and build
        K.  The frame is uploaded, then resized (``ops/resize``: cv2's
        INTER_LINEAR for colour, INTER_NEAREST for depth, bit for bit) and
        padded on the device.  Returns (bgr (H, W, 3) u8, depth (H, W)
        int32, K (3, 3) f32) on the device."""
        d = self.cfg.detector
        if (rgb_bgr.shape[0] != cam.height or rgb_bgr.shape[1] != cam.width
                or depth_u16.shape != (cam.height, cam.width)):
            raise ValueError("image size must match camera intrinsics")
        zoom = d.image_width / cam.width
        w = d.image_width
        h = int(round(cam.height * zoom))
        align = d.pyramid_alignment
        h_pad = -(-h // align) * align
        w_pad = -(-w // align) * align
        bgr = torch.from_numpy(np.ascontiguousarray(rgb_bgr, np.uint8)).to(
            self.device)
        depth = torch.from_numpy(np.asarray(depth_u16, np.int32)).to(
            self.device)
        if zoom != 1.0:
            bgr = resize.resize_linear_u8(bgr, (w, h))
            depth = resize.resize_nearest(depth, (w, h))
        if (h_pad, w_pad) != (h, w):
            bgr_pad = bgr.new_zeros((h_pad, w_pad, 3))
            bgr_pad[:h, :w] = bgr
            depth_pad = depth.new_zeros((h_pad, w_pad))
            depth_pad[:h, :w] = depth
            bgr, depth = bgr_pad, depth_pad
        if (d.image_height, d.image_width) != (h_pad, w_pad):
            # first frame of a new aspect: pin the processing dims and
            # rebuild the score tables
            self.cfg = dataclasses.replace(
                self.cfg, detector=dataclasses.replace(
                    d, image_height=h_pad, image_width=w_pad))
            if self.bank is not None:
                self._kernels = det_mod.build_match_tables(
                    self.bank, self.cfg.detector)
        fx, fy, cx, cy = gd.scale_intrinsics(cam.fx, cam.fy, cam.cx, cam.cy,
                                             zoom)
        return (bgr, depth,
                gd.intrinsics_matrix(fx, fy, cx, cy, device=self.device))

    def _roi_mask_dev(self, roi_mask: Optional[np.ndarray], frame_hw):
        """A processing-resolution ROI mask padded bottom/right to the
        (padded) frame, on the device; None stays None."""
        if roi_mask is None:
            return None
        ph = frame_hw[0] - roi_mask.shape[0]
        pw = frame_hw[1] - roi_mask.shape[1]
        if ph < 0 or pw < 0:
            raise ValueError(f"roi_mask {roi_mask.shape} larger than "
                             f"processing frame {tuple(frame_hw)}")
        return torch.from_numpy(
            np.pad(roi_mask.astype(bool), ((0, ph), (0, pw)))).to(self.device)

    def _class_mask(self, class_ids):
        return (None if class_ids is None
                else class_slot_mask(self.bank, class_ids))

    def _result(self, row: np.ndarray) -> RecoResult:
        """One RecoResult from a fetched float64 row: pose (16), valid,
        slot, class, similarity, icp_dist, inlier_ratio, match x, y."""
        slot, cls = int(row[17]), int(row[18])
        sim, icp_dist, ratio, mx, my = (float(v) for v in row[19:24])
        return RecoResult(
            obj_tag=self.bank.class_names[cls],
            world2cam=row[:16].reshape(4, 4).astype(np.float32),
            similarity=sim, icp_dist=icp_dist, inlier_ratio=ratio,
            match_rect=(mx, my, float(self._rect_wh[slot, 0]),
                        float(self._rect_wh[slot, 1])))

    def recognition_multi(self, rgb_bgr: np.ndarray, depth_u16: np.ndarray,
                          cam: CamIntrinsics,
                          max_objects: Optional[int] = None,
                          class_ids: Optional[List[str]] = None,
                          roi_mask: Optional[np.ndarray] = None
                          ) -> List[RecoResult]:
        """Multi-object Recognition: refine the top-M match candidates and
        3D-NMS the refined poses (ICP/NMS.cpp:6-40; the reference engine
        itself returns top-1, obj_reco_lmicp.cpp:111).  ``class_ids`` and
        ``roi_mask`` as in :meth:`recognition`."""
        if self.bank is None:
            raise RuntimeError("add_obj not called")
        m = max_objects or self.cfg.max_objects
        bgr, depth, scene_k = self._prepare_frame(rgb_bgr, depth_u16, cam)
        step = pipeline.recognize_multi(
            self.bank, self._model_depth_dev, self._origins_dev, bgr, depth,
            scene_k, self.cfg, m, kernels=self._kernels,
            class_mask=self._class_mask(class_ids),
            roi_mask=self._roi_mask_dev(roi_mask, bgr.shape[:2]))
        # one transfer for every field (float64 holds them all exactly)
        fields = [step.valid, step.template_slot, step.class_idx,
                  step.similarity, step.icp_dist, step.inlier_ratio,
                  step.match_x, step.match_y]
        host = torch.cat([step.poses.reshape(-1, 16).double(),
                          torch.stack([f.double() for f in fields], 1)],
                         1).cpu().numpy()
        return [self._result(row) for row in host if row[16]]

    def recognition(self, rgb_bgr: np.ndarray, depth_u16: np.ndarray,
                    cam: CamIntrinsics, roi_mask: Optional[np.ndarray] = None,
                    class_ids: Optional[List[str]] = None
                    ) -> List[RecoResult]:
        """Full Recognition (obj_reco_lmicp.cpp:86-204): match, take the
        top match, ICP-refine its pose.  ``roi_mask`` (processing
        resolution) gates matching to a region; ``class_ids`` restricts the
        search to those classes (linemod.hpp:317-325)."""
        if self.bank is None:
            raise RuntimeError("add_obj not called")
        bgr, depth, scene_k = self._prepare_frame(rgb_bgr, depth_u16, cam)
        step = pipeline.recognize_top1(
            self.bank, self._model_depth_dev, self._origins_dev, bgr, depth,
            scene_k, self.cfg, kernels=self._kernels,
            class_mask=self._class_mask(class_ids),
            roi_mask=self._roi_mask_dev(roi_mask, bgr.shape[:2]))
        return self._fetch_top1(step)[0]

    def _fetch_top1(self, step: pipeline.RecoStep,
                    extra: Optional[torch.Tensor] = None):
        """(results, extra) of a top-1 step in ONE transfer (float64 holds
        every field exactly); ``extra``, a small float tensor on the
        device, rides along and comes back as a numpy vector."""
        fields = [step.valid, step.template_slot, step.class_idx,
                  step.similarity, step.refine.icp.dist_mean,
                  step.refine.icp.inlier_ratio, step.match_x, step.match_y]
        parts = [step.pose.reshape(-1).double(),
                 torch.stack([f.double() for f in fields])]
        if extra is not None:
            parts.append(extra.reshape(-1).double())
        host = torch.cat(parts).cpu().numpy()
        return ([self._result(host[:24])] if host[16] else []), host[24:]
