"""Template-sharded LINE-MOD matching over a process mesh (counterpart of
``fealess_tpu.parallel.sharded_match``).

The reference iterates templates serially on one core (matchClass,
linemod/linemod.cpp:1451-1577).  Here the packed bank's template axis is
split over the mesh's ``t`` axis: every process builds the frame's
response planes itself (they do not depend on the templates), scores and
refines only its slice of the bank (K1 and K2 on the slice), and the
shards' top-K lists are all-gathered in rank order and merged with one
global sort.  Each shard keeps its own top-K before refinement, so the
result is the JAX layer's, not the single-device ``match_bank``'s.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.distributed.device_mesh import DeviceMesh

from fealess_tpu_torch import config as cfg
from fealess_tpu_torch import detector as det_mod
from fealess_tpu_torch.bank import TemplateBank
from fealess_tpu_torch.detector import Matches
from fealess_tpu_torch.parallel import mesh as mesh_mod


def _merge_matches(m: Matches, k: int) -> Matches:
    """Global (similarity desc, template_idx asc) sort of the
    concatenated lists, invalid entries scored -inf, then duplicate
    suppression and truncation to K (linemod.cpp:1437-1439).  The sort is
    ``jnp.lexsort((template_idx, -sim))`` as two stable sorts, so equal
    keys keep the concatenation's (rank) order."""
    sim = torch.where(m.valid, m.similarity, float("-inf"))
    order = torch.sort(m.template_idx, stable=True).indices
    order = order[torch.sort(-sim[order], stable=True).indices]
    x, y, sim = m.x[order], m.y[order], sim[order]
    cls = m.class_idx[order]
    same = torch.cat([
        torch.zeros(1, dtype=torch.bool, device=sim.device),
        (x[1:] == x[:-1]) & (y[1:] == y[:-1]) & (sim[1:] == sim[:-1])
        & (cls[1:] == cls[:-1])])
    return Matches(x=x[:k], y=y[:k], similarity=sim[:k],
                   template_slot=m.template_slot[order][:k],
                   class_idx=cls[:k], template_idx=m.template_idx[order][:k],
                   valid=(m.valid[order] & ~same)[:k])


def match_bank_sharded(bank: TemplateBank, bgr: torch.Tensor,
                       depth_mm: torch.Tensor, threshold: float,
                       det: cfg.DetectorConfig, mesh: DeviceMesh,
                       axis: str = "t", tables=None) -> Matches:
    """Template-sharded match: every process passes the whole bank and
    the frame, and every process returns the same merged global top-K.
    The bank's capacity must divide by the ``axis`` size.  Score
    ``tables`` (``detector.build_match_tables``) are built at full N from
    the planes' grid unless given, and split like the bank.
    ``template_slot`` indexes the whole bank."""
    planes = det_mod.response_planes(
        det_mod.quantized_pyramid(bgr, depth_mm, det), det)
    if tables is None:
        tables = det_mod.build_match_tables(
            bank, det, grid_hw=[(p.shape[1], p.shape[2]) for p, _ in planes])
    part, part_tables, offset = mesh_mod.shard_bank(bank, mesh, axis, tables)
    m = det_mod.match_from_planes(part, planes, threshold, det, part_tables)
    m = dataclasses.replace(m, template_slot=m.template_slot + offset)
    return _merge_matches(
        mesh_mod.all_gather_tree(m, mesh_mod.axis_group(mesh, axis)),
        det.max_candidates)


def jit_match_sharded(mesh: DeviceMesh, det: cfg.DetectorConfig,
                      threshold: float, axis: str = "t"):
    """The sharded matcher for one mesh and config, as a callable
    ``fn(bank, bgr, depth_mm)`` (the JAX name: torch compiles nothing
    here).  It builds the score tables at ``det``'s image size for the
    first bank it is called with, and again only for another bank."""
    memo = {}

    def fn(bank: TemplateBank, bgr: torch.Tensor, depth_mm: torch.Tensor):
        if memo.get("bank") is not bank:
            memo["bank"] = bank
            memo["tables"] = det_mod.build_match_tables(bank, det)
        return match_bank_sharded(bank, bgr, depth_mm, threshold, det, mesh,
                                  axis, tables=memo["tables"])
    return fn
