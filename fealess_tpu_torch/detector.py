"""The LINE-MOD detector match path (counterpart of
``fealess_tpu.detector``).

Reproduces ``Detector::match``/``matchClass`` (linemod/linemod.cpp:
1356-1577) with the JAX package's static shapes and semantics:

- quantized pyramid -> decimated response planes per level,
- coarse whole-image scores for every template at the coarsest level
  (kernel K1, :func:`fealess_tpu_torch.ops.score.coarse_scores`),
- exact top-K candidates, ordered (score desc, flat index asc) — the tie
  order of ``jax.lax.top_k`` (:func:`exact_top_k_flat`; the per-row form
  :func:`exact_top_k_rows` gives the same),
- per-level 16x16 local refinement (kernel K2, one launch a level) with
  matchClass's clamp, offset and score arithmetic (linemod.cpp:1509-1573),
- final (similarity desc, template_id asc) order with duplicate
  suppression (linemod.cpp:1437-1439).

Scores match the reference: raw threshold ``int(2nf + thr/100*2nf + 0.5)``,
coarse score ``raw*100/(4nf)+0.5``, refined score ``best*100/(4nf)``
(linemod.cpp:1487, 1502, 1566), in float32 with the JAX operation order.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from fealess_tpu_torch import config as cfg
from fealess_tpu_torch.bank import TemplateBank
from fealess_tpu_torch.ops import quantize as q
from fealess_tpu_torch.ops import image as fi
from fealess_tpu_torch.ops import response, score

_I32 = torch.int32


@dataclasses.dataclass
class Matches:
    """Static-K match results, sorted (similarity desc, template_idx asc);
    ``valid`` gates live entries (cf. cup_linemod::Match,
    linemod.hpp:253-286)."""
    x: torch.Tensor
    y: torch.Tensor
    similarity: torch.Tensor
    template_slot: torch.Tensor
    class_idx: torch.Tensor
    template_idx: torch.Tensor
    valid: torch.Tensor


def quantized_pyramid(bgr: torch.Tensor, depth_mm: torch.Tensor,
                      det: cfg.DetectorConfig, masks: Optional[List] = None):
    """Per-level (quantized_cg, quantized_dn) images (linemod.cpp:
    1388-1416): ColorGradient re-quantizes a pyrDown'd source, DepthNormal
    NN-downsamples its level-0 image.  ``masks`` is [cg_mask, dn_mask]."""
    cg, dn = det.color_gradient, det.depth_normal
    use_cg = "color_gradient" in det.modalities
    use_dn = "depth_normal" in det.modalities
    levels = []
    src = bgr
    qdn = (q.quantize_normals(depth_mm, dn.distance_threshold,
                              dn.difference_threshold) if use_dn else None)
    cg_mask = dn_mask = None
    if masks is not None:
        cg_mask, dn_mask = (masks * 2)[:2] if len(masks) == 1 else masks
    for l in range(det.pyramid_levels):
        if l > 0:
            src = fi.pyr_down_u8(src)
            qdn = None if qdn is None else qdn[::2, ::2]
            cg_mask = None if cg_mask is None else cg_mask[::2, ::2]
            dn_mask = None if dn_mask is None else dn_mask[::2, ::2]
        mods = []
        if use_cg:
            qcg = q.quantize_gradients(src, cg.weak_threshold)[0]
            mods.append(q.apply_mask(qcg, cg_mask))
        if use_dn:
            mods.append(q.apply_mask(qdn, dn_mask))
        levels.append(tuple(mods))
    return levels


def _offset(t: int) -> int:
    """Pixel offset of a decimated cell's reported position
    (linemod.cpp:1495, 1517)."""
    return t // 2 + (t % 2 - 1)


def response_planes(levels, det: cfg.DetectorConfig):
    """Decimated response stacks per level: list of ((C_all, Hd, Wd) u8,
    (h, w)), channels concatenated over the modalities."""
    out = []
    for l, mods in enumerate(levels):
        t = det.t_at_level[l]
        h, w = mods[0].shape
        planes = torch.cat([response.build_level_2d(quant, t)
                            for quant in mods]).to(torch.uint8)
        out.append((planes, (h, w)))
    return out


def _kernel_hw(bank: TemplateBank, det: cfg.DetectorConfig, l: int,
               hd: int, wd: int) -> int:
    """Template span at level ``l`` in decimated cells; bounds the tables'
    offsets."""
    if bank.max_span <= 0:
        return max(hd, wd)
    return min((bank.max_span >> l) // det.t_at_level[l] + 1, max(hd, wd))


def _level_table(bank: TemplateBank, det: cfg.DetectorConfig, l: int,
                 nb: int):
    """Score table for level ``l``: ``c``/``ry``/``rx`` (N, M*F) int32,
    valid features first and grouped by ``rx`` (stable), padding zeroed;
    ``bstart`` (N, NB+1) int32 cumulative ``rx`` bucket boundaries, whose
    last column counts the valid features."""
    t = det.t_at_level[l]
    n = bank.capacity
    dev = bank.device
    m_idx = torch.arange(bank.modalities, dtype=_I32, device=dev)[None, :,
                                                                  None]
    fx = bank.feat_x[:, l]
    fy = bank.feat_y[:, l]
    fl = bank.feat_label[:, l]
    c = ((m_idx * 8 + fl) * (t * t) + (fy % t) * t + (fx % t)).reshape(n, -1)
    ry = (fy // t).reshape(n, -1)
    rx = (fx // t).reshape(n, -1)
    fv = bank.feat_valid[:, l].reshape(n, -1) & (rx < nb) & (ry < nb)
    key = torch.where(fv, rx, nb)          # invalid last, bucketed by rx
    order = torch.sort(key, dim=1, stable=True).indices
    fv_s = fv.gather(1, order)
    c, ry, rx = (torch.where(fv_s, a.gather(1, order), 0).to(_I32)
                 for a in (c, ry, rx))
    counts = (key[:, None, :] == torch.arange(nb, device=dev)[None, :, None]
              ).sum(dim=2)
    bstart = torch.cat([torch.zeros((n, 1), dtype=_I32, device=dev),
                        counts.cumsum(dim=1).to(_I32)], dim=1)
    return {"c": c.contiguous(), "ry": ry.contiguous(),
            "rx": rx.contiguous(), "bstart": bstart}


def build_match_tables(bank: TemplateBank, det: cfg.DetectorConfig,
                       grid_hw=None, levels=None):
    """Per-level score tables (bank-dependent only: build once per bank).
    ``grid_hw`` gives each level's decimated (Hd, Wd); by default they
    follow ``det.image_height``/``image_width``."""
    if levels is None:
        levels = tuple(range(bank.levels))
    tables = []
    for l in range(bank.levels):
        if l not in levels:
            tables.append(None)
            continue
        t = det.t_at_level[l]
        if grid_hw is None:
            hd = (det.image_height >> l) // t
            wd = (det.image_width >> l) // t
        else:
            hd, wd = grid_hw[l]
        tables.append(_level_table(bank, det, l,
                                   _kernel_hw(bank, det, l, hd, wd)))
    return tuple(tables)


def exact_top_k_flat(flat: torch.Tensor, k: int):
    """The ``k`` largest entries of the 1-D ``flat`` and their int64 flat
    indices, in ``jax.lax.top_k``'s order (value descending, then flat index
    ascending): one stable descending sort, then its first ``k``.
    ``torch.topk`` promises no tie order; the coarse stage serves this
    form."""
    scores, idx = torch.sort(flat, descending=True, stable=True)
    return scores[:k], idx[:k]


def exact_top_k_rows(flat: torch.Tensor, k: int, rows: int):
    """Exact global top-k of the 1-D ``flat`` (equal to
    :func:`exact_top_k_flat`, tie order included) as a top-k of each row of
    its ``(rows, cols)`` reshape and a merge of the rows' survivors.  Each
    row's top-k is a stable descending sort, so ties keep column order, and
    the merge is a second stable sort over the survivors laid out in (row,
    rank) order, which is flat-index order among equal values.  Falls back
    to the flat form when the rows are too small to cover ``k``."""
    p = flat.shape[0] // rows
    kk = min(k, p)
    if rows * kk < k or p <= 1:
        return exact_top_k_flat(flat, k)
    s2, i2 = torch.sort(flat.reshape(rows, p), dim=1, descending=True,
                        stable=True)
    gidx = (torch.arange(rows, device=flat.device)[:, None] * p
            + i2[:, :kk])
    top, im = exact_top_k_flat(s2[:, :kk].reshape(-1), k)
    return top, gidx.reshape(-1)[im]


def match_bank(bank: TemplateBank, bgr: torch.Tensor, depth_mm: torch.Tensor,
               threshold: float, det: cfg.DetectorConfig,
               masks: Optional[List] = None, kernels=None, class_mask=None,
               roi_box=None) -> Matches:
    """Full match over the template bank.  ``bgr`` (H, W, 3) u8 and
    ``depth_mm`` (H, W) int32 on the bank's device.  ``kernels`` are the
    tables of :func:`build_match_tables`; ``class_mask`` a (capacity,)
    bool slot gate; ``roi_box`` a (4,) f32 (x0, y0, x1, y1) level-0 box a
    candidate's template rect must intersect."""
    levels = quantized_pyramid(bgr, depth_mm, det, masks)
    planes = response_planes(levels, det)
    return match_from_planes(bank, planes, threshold, det, kernels,
                             class_mask=class_mask, roi_box=roi_box)


def coarse_candidates(bank: TemplateBank, planes, threshold: float,
                      det: cfg.DetectorConfig, kernels, class_mask=None,
                      roi_box=None):
    """Coarse stage (linemod.cpp:1462-1506): K1 scores, candidate gates
    and the exact top-K.  Returns (score, slot, x, y) of the K best
    (K = ``det.max_candidates``), x/y at the coarse level; unfilled slots
    score -inf."""
    l_coarse = det.pyramid_levels - 1
    t_c = det.t_at_level[l_coarse]
    d_c, (h_c, w_c) = planes[l_coarse]
    hd, wd = h_c // t_c, w_c // t_c
    p = hd * wd
    dev = d_c.device

    raw_i = score.coarse_scores(d_c, kernels[l_coarse])      # (N, Hd, Wd)

    nf_c = bank.num_features()[:, l_coarse]
    thr = torch.tensor(threshold, dtype=torch.float32, device=dev) / 100.0
    two_nf = (2 * nf_c).to(torch.float32)
    raw_thr = (two_nf + thr * two_nf + 0.5).to(_I32)
    wf = (bank.width[:, l_coarse] - 1) // t_c + 1
    hf = (bank.height[:, l_coarse] - 1) // t_c + 1
    px_idx = torch.arange(wd, device=dev)[None, None, :]
    py_idx = torch.arange(hd, device=dev)[None, :, None]
    slot_ok = bank.valid
    if class_mask is not None:
        slot_ok = slot_ok & class_mask
    cand_ok = ((raw_i > raw_thr[:, None, None])
               & (px_idx <= (wd - wf)[:, None, None])
               & (py_idx <= (hd - hf)[:, None, None])
               & slot_ok[:, None, None])
    if roi_box is not None:
        # the template rect [x, x + w0) x [y, y + h0) at level-0 scale must
        # intersect the box
        sc = float(1 << l_coarse)
        off_cf = float(_offset(t_c))
        cand_x0 = (px_idx.to(torch.float32) * t_c + off_cf) * sc
        cand_y0 = (py_idx.to(torch.float32) * t_c + off_cf) * sc
        w0 = bank.width[:, 0].to(torch.float32)[:, None, None]
        h0 = bank.height[:, 0].to(torch.float32)[:, None, None]
        cand_ok = (cand_ok & (cand_x0 + w0 > roi_box[0])
                   & (cand_x0 < roi_box[2])
                   & (cand_y0 + h0 > roi_box[1])
                   & (cand_y0 < roi_box[3]))
    # 100 / (4 nf) as a true float32 division (``100.0 / t`` in torch is
    # reciprocal-then-multiply and can differ in the last bit)
    hundred = torch.tensor(100.0, dtype=torch.float32, device=dev)
    scale = hundred / (4 * nf_c.clamp(min=1)).to(torch.float32)
    flat = torch.where(cand_ok,
                       raw_i.to(torch.float32) * scale[:, None, None] + 0.5,
                       float("-inf")).reshape(-1)
    top_scores, top_idx = exact_top_k_flat(flat, det.max_candidates)
    tslot = top_idx // p
    pidx = top_idx % p
    off_c = _offset(t_c)
    x = ((pidx % wd) * t_c + off_c).to(_I32)
    y = ((pidx // wd) * t_c + off_c).to(_I32)
    return top_scores, tslot, x, y


def refine_level(bank: TemplateBank, planes, det: cfg.DetectorConfig,
                 kernels, l: int, tslot: torch.Tensor, x: torch.Tensor,
                 y: torch.Tensor, nf: torch.Tensor):
    """One refinement level (linemod.cpp:1509-1566): the candidates'
    level-(l+1) positions ``x``/``y`` clamped at level ``l``, their 16x16
    windows scored (kernel K2, :func:`score.local_refine`, one launch on
    the card) and moved to the first maximum.  ``nf`` is
    ``bank.num_features()``.  Returns (x, y, similarity)."""
    t = det.t_at_level[l]
    d_l, size = planes[l]
    _, x, y, best, nf_l = score.local_refine(
        d_l, kernels[l], tslot, x, y, bank.width, bank.height, nf, l, t,
        _offset(t), size)
    sim = best.to(torch.float32) * 100.0 / (
        4 * nf_l.clamp(min=1)).to(torch.float32)
    return x, y, sim


def match_from_planes(bank: TemplateBank, planes, threshold: float,
                      det: cfg.DetectorConfig, kernels=None, class_mask=None,
                      roi_box=None) -> Matches:
    """Score the bank against decimated response planes: K1 at the coarse
    level, exact top-K, K2 on each survivor's 16x16 window at every finer
    level, then the final order (semantics of matchClass,
    linemod.cpp:1451-1577, as in the JAX package)."""
    if kernels is None or any(kernels[lv] is None
                              for lv in range(det.pyramid_levels)):
        kernels = build_match_tables(
            bank, det, grid_hw=[(pl[0].shape[1], pl[0].shape[2])
                                for pl in planes])
    sim, tslot, x, y = coarse_candidates(bank, planes, threshold, det,
                                         kernels, class_mask, roi_box)
    valid = torch.isfinite(sim)
    nf = bank.num_features()
    for l in range(det.pyramid_levels - 2, -1, -1):
        x, y, sim = refine_level(bank, planes, det, kernels, l, tslot, x, y,
                                 nf)
        valid = valid & (sim >= threshold)

    # final (similarity desc, template_idx asc) order — jnp.lexsort as two
    # stable sorts — and duplicate suppression (linemod.cpp:1437-1439)
    sim = torch.where(valid, sim, float("-inf"))
    tpl_idx = bank.template_idx[tslot]
    order = torch.sort(tpl_idx, stable=True).indices
    order = order[torch.sort(sim[order], descending=True, stable=True).indices]
    x, y, sim, tslot, valid = (x[order], y[order], sim[order], tslot[order],
                               valid[order])
    cls = bank.class_idx[tslot]
    tpl = bank.template_idx[tslot]
    same_as_prev = torch.cat([
        torch.zeros(1, dtype=torch.bool, device=sim.device),
        (x[1:] == x[:-1]) & (y[1:] == y[:-1]) & (sim[1:] == sim[:-1])
        & (cls[1:] == cls[:-1])])
    return Matches(x=x, y=y, similarity=sim, template_slot=tslot.to(_I32),
                   class_idx=cls, template_idx=tpl,
                   valid=valid & ~same_as_prev)
