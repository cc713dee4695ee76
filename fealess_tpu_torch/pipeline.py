"""Detection refinement glue and the Recognition steps, single- and
multi-object (counterpart of ``fealess_tpu.pipeline``).

Reimplements ``detection()`` (ICP/detection.cpp:11-254) over fixed-size
crops: template and scene depth are back-projected with their own
intrinsics to mm, equal-size rects are cropped and index-paired (valid
where both z <= valid_depth_max_mm), translation init mode 2
(detection.cpp:147-199), ICP, then ``T = R t_init + T_icp``,
``R = R_icp r_match`` (detection.cpp:232-234).

All indexing with match results stays on the device (gathers, not Python
ints), so a Recognition step reads nothing back to the host except ICP's
loop checks and, on the multi-object path, the NMS inputs.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from fealess_tpu import config as cfg
from fealess_tpu_torch import detector as det_mod
from fealess_tpu_torch import icp as icp_mod
from fealess_tpu_torch import nms as nms_mod
from fealess_tpu_torch.geometry import depth as gd
from fealess_tpu_torch.geometry import transforms as tf


@dataclasses.dataclass
class RefineResult:
    r: torch.Tensor           # (3, 3) final rotation (world2cam)
    t: torch.Tensor           # (3,) final translation, mm
    icp: icp_mod.IcpResult
    n_pairs: torch.Tensor     # valid paired points fed to ICP


@dataclasses.dataclass
class RecoStep:
    """Device-side Recognition result (cf. TObjRecoResult,
    lotus_common.h:95-100)."""
    pose: torch.Tensor        # (4, 4) f32
    valid: torch.Tensor       # a match above threshold existed
    similarity: torch.Tensor
    class_idx: torch.Tensor
    template_slot: torch.Tensor
    match_x: torch.Tensor
    match_y: torch.Tensor
    refine: RefineResult


def _crop_points_mm(depth: torch.Tensor, k: torch.Tensor, x0, y0,
                    crop_h: int, crop_w: int) -> torch.Tensor:
    """Back-project the (crop_h, crop_w) window at (x0, y0) of an int32
    depth image (mm) to (crop_h, crop_w, 3) points in mm, with absolute
    pixel coordinates.  The image is zero-padded bottom/right by the crop
    size and the origin clamped to [0, W] x [0, H] (as the JAX version
    pads, so ``dynamic_slice`` never clamps); a window past the edge reads
    invalid depth.  Zero depth becomes NaN, so z-gates compare False."""
    h, w = depth.shape
    padded = F.pad(depth, (0, crop_w, 0, crop_h))
    x0c = torch.as_tensor(x0, device=depth.device).clamp(0, w)
    y0c = torch.as_tensor(y0, device=depth.device).clamp(0, h)
    u = x0c + torch.arange(crop_w, device=depth.device)
    v = y0c + torch.arange(crop_h, device=depth.device)
    window = padded[v[:, None], u[None, :]]
    z = torch.where(window == 0, float("nan"),
                    window.to(torch.float32) / 1000.0)
    fx, fy = k[0, 0], k[1, 1]
    cx, cy = k[0, 2], k[1, 2]
    x = (u.to(torch.float32)[None, :] - cx) / fx * z
    y = (v.to(torch.float32)[:, None] - cy) / fy * z
    return torch.stack([x, y, z], dim=-1) * 1000.0


def paired_clouds(scene_depth, scene_k, model_depth, template_k, rect_w,
                  rect_h, model_x0, model_y0, match_x, match_y,
                  engine: cfg.EngineConfig, crop_h: int, crop_w: int):
    """The ICP inputs of one match: index-paired, compacted, padded clouds.

    Returns (ref (P, 3), model (P, 3) shifted by the centroid offset,
    pair_mask (P,), ref_normals (P, 3) or None, t_tmp (3,)), P =
    min(crop_h*crop_w, icp.max_points)."""
    model_pts = _crop_points_mm(model_depth, template_k, model_x0, model_y0,
                                crop_h, crop_w)
    ref_pts = _crop_points_mm(scene_depth, scene_k, match_x, match_y,
                              crop_h, crop_w)
    plane_mode = engine.icp.mode == "point_to_plane"
    ref_normals = (gd.normals_from_point_image(ref_pts).reshape(-1, 3)
                   if plane_mode else None)

    dev = scene_depth.device
    uu = torch.arange(crop_w, device=dev)[None, :]
    vv = torch.arange(crop_h, device=dev)[:, None]
    in_rect = (uu < rect_w) & (vv < rect_h)
    z_max = engine.icp.valid_depth_max_mm
    z_ok = (model_pts[..., 2] <= z_max) & (ref_pts[..., 2] <= z_max)
    pair_mask = (in_rect & z_ok).reshape(-1)

    pad = icp_mod.PAD_COORD
    model_flat = torch.where(pair_mask[:, None], model_pts.reshape(-1, 3), pad)
    ref_flat = torch.where(pair_mask[:, None], ref_pts.reshape(-1, 3), pad)

    # Compact valid pairs to the ICP point budget with a stable sort: pairs
    # stay index-aligned and in raster order; the excess beyond max_points
    # is dropped (the JAX version's documented divergence).
    cap = engine.icp.max_points
    if cap < pair_mask.shape[0]:
        order = torch.sort((~pair_mask).to(torch.uint8), stable=True).indices
        take = order[:cap]
        model_flat = model_flat.index_select(0, take)
        ref_flat = ref_flat.index_select(0, take)
        pair_mask = pair_mask.index_select(0, take)
        if ref_normals is not None:
            ref_normals = ref_normals.index_select(0, take)

    # Translation init, mode test_id=2 (detection.cpp:147-199).
    w = pair_mask.to(torch.float32)
    count = w.sum().clamp(min=1.0)
    m_centroid = torch.where(pair_mask[:, None], model_flat, 0.0).sum(0) / count
    r_centroid = torch.where(pair_mask[:, None], ref_flat, 0.0).sum(0) / count
    t_tmp = r_centroid - m_centroid
    model_flat = torch.where(pair_mask[:, None], model_flat + t_tmp,
                             model_flat)
    return ref_flat, model_flat, pair_mask, ref_normals, t_tmp


def refine_match(scene_depth, scene_k, model_depth, template_k, rect_w,
                 rect_h, model_x0, model_y0, match_x, match_y,
                 r_match: torch.Tensor, t_match: torch.Tensor,
                 engine: cfg.EngineConfig, crop_h: int = 256,
                 crop_w: int = 256) -> RefineResult:
    """``detection()`` for one match.  ``model_depth`` is the template's
    depth already in mm (int32); ``model_x0/model_y0`` the template rect
    origin; ``match_x/match_y`` the scene rect origin; both rects are
    ``rect_w x rect_h``."""
    ref, model, pair_mask, ref_normals, t_tmp = paired_clouds(
        scene_depth, scene_k, model_depth, template_k, rect_w, rect_h,
        model_x0, model_y0, match_x, match_y, engine, crop_h, crop_w)
    t_init = t_tmp + t_match
    result = icp_mod.icp_refine(ref, model, pair_mask, engine.icp,
                                ref_normals=ref_normals)
    return RefineResult(r=result.r @ r_match, t=result.r @ t_init + result.t,
                        icp=result, n_pairs=pair_mask.sum())


def candidate_inputs(bank, model_depth_stack, depth_origins, slot,
                     engine: cfg.EngineConfig):
    """One candidate's template data gathered on the device: (model depth
    (crop, crop), template K (3, 3), rect_w, rect_h, model_x0, model_y0,
    r_match, t_match)."""
    sel = slot.reshape(1).to(torch.int64)

    def pick(a):
        return a.index_select(0, sel)[0]

    r_match, t_match, _ = tf.pose_from_13floats(pick(bank.pose))
    width0, height0 = pick(bank.width)[0], pick(bank.height)[0]
    off_x, off_y = pick(bank.offset_x)[0], pick(bank.offset_y)[0]
    dx0, dy0 = pick(depth_origins)
    # the hard-coded rendering intrinsics, principal point moved to the
    # model depth crop's origin (ICP/common.cpp:326-372)
    template_k = gd.intrinsics_matrix(engine.template_fx, engine.template_fy,
                                      0.0, 0.0, device=bank.device)
    template_k[0, 2] = engine.template_cx - dx0.to(torch.float32)
    template_k[1, 2] = engine.template_cy - dy0.to(torch.float32)
    return (pick(model_depth_stack), template_k, width0, height0,
            off_x - dx0, off_y - dy0, r_match, t_match)


def _refine_candidate(bank, model_depth_stack, depth_origins, scene_depth,
                      scene_k, slot, mx, my, engine: cfg.EngineConfig,
                      crop: int):
    """Gather one candidate's template data and ICP-refine it -> (pose
    (4, 4), RefineResult)."""
    (model_depth, template_k, rect_w, rect_h, model_x0, model_y0, r_match,
     t_match) = candidate_inputs(bank, model_depth_stack, depth_origins,
                                 slot, engine)
    res = refine_match(scene_depth, scene_k, model_depth, template_k, rect_w,
                       rect_h, model_x0, model_y0, mx, my, r_match, t_match,
                       engine, crop_h=crop, crop_w=crop)
    return tf.pose_matrix_4x4(res.r, res.t), res


def recognize_top1(bank, model_depth_stack: torch.Tensor,
                   depth_origins: torch.Tensor, bgr: torch.Tensor,
                   scene_depth: torch.Tensor, scene_k: torch.Tensor,
                   engine: cfg.EngineConfig, kernels=None, class_mask=None,
                   roi_mask=None, roi_box=None) -> RecoStep:
    """The Recognition step: match the whole bank, take the best match
    (obj_reco_lmicp.cpp:111 takes top-1 only), gather its model depth and
    pose, ICP-refine.

    ``model_depth_stack`` (N, crop, crop) int32 mm per slot, pre-cropped at
    ``depth_origins`` (N, 2) int32; ``bgr`` (H, W, 3) u8 and
    ``scene_depth`` (H, W) int32 at the processing resolution; ``scene_k``
    (3, 3) f32 — all on the bank's device.
    """
    crop = model_depth_stack.shape[-1]
    masks = None if roi_mask is None else [roi_mask, roi_mask]
    matches = det_mod.match_bank(bank, bgr, scene_depth,
                                 engine.matching_threshold, engine.detector,
                                 masks=masks, kernels=kernels,
                                 class_mask=class_mask, roi_box=roi_box)
    slot = matches.template_slot[0]
    mx, my = matches.x[0], matches.y[0]
    pose, res = _refine_candidate(bank, model_depth_stack, depth_origins,
                                  scene_depth, scene_k, slot, mx, my, engine,
                                  crop)
    return RecoStep(pose=pose, valid=matches.valid[0],
                    similarity=matches.similarity[0],
                    class_idx=matches.class_idx[0], template_slot=slot,
                    match_x=mx, match_y=my, refine=res)


@dataclasses.dataclass
class MultiRecoStep:
    """Multi-object Recognition result: the top-M refined candidates after
    3D NMS.  Slot ``i`` is live when ``valid[i]``; its fields are taken
    from the NMS cluster winner (ICP/NMS.cpp:30-39)."""
    poses: torch.Tensor          # (M, 4, 4)
    valid: torch.Tensor          # (M,) cluster seeded here, above threshold
    similarity: torch.Tensor     # (M,)
    class_idx: torch.Tensor      # (M,)
    template_slot: torch.Tensor  # (M,)
    icp_dist: torch.Tensor       # (M,)
    inlier_ratio: torch.Tensor   # (M,)
    n_pairs: torch.Tensor        # (M,)
    match_x: torch.Tensor        # (M,)
    match_y: torch.Tensor        # (M,)


def recognize_multi(bank, model_depth_stack: torch.Tensor,
                    depth_origins: torch.Tensor, bgr: torch.Tensor,
                    scene_depth: torch.Tensor, scene_k: torch.Tensor,
                    engine: cfg.EngineConfig, max_objects: int,
                    kernels=None, class_mask=None,
                    roi_mask=None) -> MultiRecoStep:
    """Multi-object Recognition: match the bank, ICP-refine each of the
    top-M candidates (M = ``max_objects``; invalid ones too, as the JAX
    version's map over them does), then 3D NMS over the refined
    translations (ICP/NMS.cpp:6-40).  Arguments as
    :func:`recognize_top1`."""
    crop = model_depth_stack.shape[-1]
    masks = None if roi_mask is None else [roi_mask, roi_mask]
    matches = det_mod.match_bank(bank, bgr, scene_depth,
                                 engine.matching_threshold, engine.detector,
                                 masks=masks, kernels=kernels,
                                 class_mask=class_mask)
    m = max_objects
    slots, mxs, mys = (matches.template_slot[:m], matches.x[:m],
                       matches.y[:m])
    poses, refs = [], []
    for i in range(slots.shape[0]):
        pose, res = _refine_candidate(bank, model_depth_stack, depth_origins,
                                      scene_depth, scene_k, slots[i], mxs[i],
                                      mys[i], engine, crop)
        poses.append(pose)
        refs.append(res)
    poses = torch.stack(poses)
    dist_mean = torch.stack([r.icp.dist_mean for r in refs])
    ratio = torch.stack([r.icp.inlier_ratio for r in refs])
    icp_ok = torch.stack([r.icp.ok for r in refs])
    n_pairs = torch.stack([r.n_pairs for r in refs])

    # the model-point count is the ICP pair count, the score its dist_mean
    icp_dist = torch.where(dist_mean < 0, 1e9, dist_mean)
    nms = nms_mod.nms_3d(poses[:, :3, 3], icp_dist, n_pairs,
                         matches.valid[:m] & icp_ok,
                         engine.nms_object_distance)
    w = nms.winner.clamp(min=0).to(torch.int64).to(poses.device)
    return MultiRecoStep(
        poses=poses[w], valid=nms.keep.to(poses.device),
        similarity=matches.similarity[:m][w],
        class_idx=matches.class_idx[:m][w], template_slot=slots[w],
        icp_dist=dist_mean[w], inlier_ratio=ratio[w], n_pairs=n_pairs[w],
        match_x=mxs[w], match_y=mys[w])
