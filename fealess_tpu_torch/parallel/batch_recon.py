"""Batch Recognition over a process mesh (counterpart of
``fealess_tpu.parallel.batch_recon``).

A batch of RGB-D frames splits over the mesh's ``d`` axis; every process
runs the whole Recognition step (match, top-1, ICP refine:
``pipeline.recognize_top1``) on its frames with the bank, model depths
and score tables replicated, and one all-gather returns the batch's
results to every process.  With the bank also split over ``t``, the
frame x template mesh of :func:`match_batch_2d` merges each frame's
shards' top-K lists within its row.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.distributed.device_mesh import DeviceMesh

from fealess_tpu_torch import config as cfg
from fealess_tpu_torch import detector as det_mod
from fealess_tpu_torch import pipeline
from fealess_tpu_torch.bank import TemplateBank
from fealess_tpu_torch.detector import Matches
from fealess_tpu_torch.parallel import mesh as mesh_mod
from fealess_tpu_torch.parallel.sharded_match import _merge_matches


def recognize_batch(bank: TemplateBank, model_depth_stack: torch.Tensor,
                    depth_origins: torch.Tensor, bgr_batch: torch.Tensor,
                    depth_batch: torch.Tensor, scene_k: torch.Tensor,
                    engine: cfg.EngineConfig,
                    kernels=None) -> pipeline.RecoStep:
    """Recognition over a leading frame axis on one device, a frame at a
    time; the RecoStep's fields stacked on that axis."""
    return mesh_mod.stack_tree([
        pipeline.recognize_top1(bank, model_depth_stack, depth_origins,
                                bgr_batch[i], depth_batch[i], scene_k,
                                engine, kernels=kernels)
        for i in range(bgr_batch.shape[0])])


def _my_frames(mesh: DeviceMesh, axis: str, n_frames: int) -> slice:
    i, n = mesh_mod.axis_index(mesh, axis)
    if n_frames % n:
        raise ValueError(f"{n_frames} frames do not divide into {n} shards "
                         f"on axis {axis!r}")
    size = n_frames // n
    return slice(i * size, (i + 1) * size)


def match_batch_2d(bank: TemplateBank, bgr_batch: torch.Tensor,
                   depth_batch: torch.Tensor, threshold: float,
                   det: cfg.DetectorConfig, mesh: DeviceMesh, tables=None,
                   frame_axis: str = "d",
                   template_axis: str = "t") -> Matches:
    """Frame x template matching: frames split over ``frame_axis``, the
    bank and score tables over ``template_axis``; each frame's shard
    lists are all-gathered within the template group and merged as in
    ``sharded_match``, then the frames are all-gathered over the frame
    axis.  Every process returns the (B, K) result."""
    if tables is None:
        tables = det_mod.build_match_tables(bank, det)
    part, part_tables, offset = mesh_mod.shard_bank(bank, mesh,
                                                    template_axis, tables)
    mine = _my_frames(mesh, frame_axis, bgr_batch.shape[0])
    local = []
    for bgr, depth in zip(bgr_batch[mine], depth_batch[mine]):
        planes = det_mod.response_planes(
            det_mod.quantized_pyramid(bgr, depth, det), det)
        m = det_mod.match_from_planes(part, planes, threshold, det,
                                      part_tables)
        local.append(dataclasses.replace(
            m, template_slot=m.template_slot + offset))
    b = len(local)
    g = mesh_mod.all_gather_tree(mesh_mod.stack_tree(local),
                                 mesh_mod.axis_group(mesh, template_axis))
    # (shards * b, K) in shard order -> (b, shards * K): frame f's row is
    # its shards' lists side by side, as JAX's tiled all_gather lays it out
    rows = mesh_mod.tree_map(
        lambda a: a.reshape(-1, b, a.shape[1]).transpose(0, 1).reshape(b, -1),
        g)
    merged = mesh_mod.stack_tree([
        _merge_matches(mesh_mod.tree_map(lambda a: a[f], rows),
                       det.max_candidates) for f in range(b)])
    return mesh_mod.all_gather_tree(merged,
                                    mesh_mod.axis_group(mesh, frame_axis))


def recognize_batch_sharded(bank: TemplateBank,
                            model_depth_stack: torch.Tensor,
                            depth_origins: torch.Tensor,
                            bgr_batch: torch.Tensor,
                            depth_batch: torch.Tensor,
                            scene_k: torch.Tensor, engine: cfg.EngineConfig,
                            mesh: DeviceMesh, axis: str = "d",
                            kernels=None) -> pipeline.RecoStep:
    """Frame-sharded batch Recognition: every process passes the whole
    batch, runs :func:`recognize_batch` on its contiguous share of the
    frames (the batch must divide by the ``axis`` size) and returns the
    whole batch's RecoStep (one all-gather)."""
    mine = _my_frames(mesh, axis, bgr_batch.shape[0])
    local = recognize_batch(bank, model_depth_stack, depth_origins,
                            bgr_batch[mine], depth_batch[mine], scene_k,
                            engine, kernels=kernels)
    return mesh_mod.all_gather_tree(local, mesh_mod.axis_group(mesh, axis))
