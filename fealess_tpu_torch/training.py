"""Template extraction, the offline training path (counterpart of
``fealess_tpu.training``).

Reimplements ``Detector::addTemplate`` (linemod/linemod.cpp:1579-1615):
quantize each modality, extract candidate features per pyramid level, pick
scattered features greedily, crop all templates of the view to a common
bounding box.  Quantization and pyrDown run on the device through the
port's front-end (``ops.quantize``, ``ops.image``, bitwise equal to the JAX
package's), once over a batch of views.  Candidate scoring and the greedy
selection are sequential (selectScatteredFeatures, linemod.cpp:135-164)
and run on the host, one native call a view and modality through
``libfealess_host``, which ``io.native`` builds at first use from
``native/fealess_host``.  The numpy functions here are its plain twin,
with identical results; they run only where ``io.native``'s library was
set aside (``native._LIB = None`` with ``native._SEARCHED = True``), as
the tests do.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from typing import List, Optional

import numpy as np
import torch

from fealess_tpu_torch import config as cfg
from fealess_tpu_torch.bank import TemplateView
from fealess_tpu_torch.io import native as native_host
from fealess_tpu_torch.ops import image as fi
from fealess_tpu_torch.ops import quantize as q


def have_native() -> bool:
    """True when the extraction runs through libfealess_host (built at
    first call); False only where a caller set the library aside."""
    return native_host.have_native()


# candidate pixels hold one-hot bitmasks: 1 << k -> k
_LABEL_LUT = np.full(256, -1, np.int32)
for _k in range(8):
    _LABEL_LUT[1 << _k] = _k


def _erode3_np(mask: np.ndarray, iterations: int = 1) -> np.ndarray:
    """3x3 binary erosion, BORDER_REPLICATE."""
    m = mask.astype(bool)
    for _ in range(iterations):
        p = np.pad(m, 1, mode="edge")
        h, w = m.shape
        acc = np.ones_like(m)
        for dy in range(3):
            for dx in range(3):
                acc &= p[dy:dy + h, dx:dx + w]
        m = acc
    return m


def distance_transform_chessboard(nonzero: np.ndarray) -> np.ndarray:
    """Exact chessboard (DIST_C, 3x3) distance of nonzero pixels to the
    nearest zero pixel, ``cv::distanceTransform(.., DIST_C, 3)``
    (linemod.cpp:763): a two-pass chamfer, vectorized per row (the in-row
    dependency ``d[c] = min(a[c], d[c-1]+1)`` is ``c + cummin(a[c] - c)``)."""
    h, w = nonzero.shape
    idx = np.arange(w, dtype=np.float64)

    def _pass(d: np.ndarray) -> np.ndarray:
        out = np.empty_like(d)
        prev = np.full(w, np.inf)
        for r in range(h):
            up = np.minimum(prev, np.minimum(
                np.concatenate(([np.inf], prev[:-1])),
                np.concatenate((prev[1:], [np.inf]))))
            a = np.minimum(d[r], up + 1.0)
            row = idx + np.minimum.accumulate(a - idx)
            prev = row
            out[r] = row
        return out

    d0 = np.where(nonzero, np.inf, 0.0)
    d1 = _pass(d0)
    d2 = _pass(d1[::-1, ::-1])[::-1, ::-1]
    return np.minimum(d1, d2).astype(np.float32)


def _chamfer(nonzero: np.ndarray) -> np.ndarray:
    if have_native():
        return native_host.chamfer_chessboard(nonzero)
    return distance_transform_chessboard(nonzero)


def select_scattered_features(candidates: np.ndarray, scores: np.ndarray,
                              num_features: int, distance: float) -> np.ndarray:
    """Greedy scattered-feature selection (linemod.cpp:135-164).

    ``candidates`` is (K, 3) int (x, y, label) already stable-sorted by
    descending score; returns (num_features, 3) int32.

    A candidate is kept when every kept feature lies at squared distance
    >= distance^2 from it.  Instead of testing each kept feature, the
    pixels closer than that to any kept feature are marked in a grid over
    the candidates' extent (redrawn whenever the distance shrinks), so
    each candidate costs one lookup.
    """
    xs = candidates[:, 0].astype(np.int64)
    ys = candidates[:, 1].astype(np.int64)
    yy = np.arange(int(ys.max()) + 1)[:, None]
    xx = np.arange(int(xs.max()) + 1)[None, :]
    blocked = np.zeros((len(yy), xx.shape[1]), bool)
    kept: List[int] = []

    def block(i: int, distance_sq: float) -> None:
        r = int(np.sqrt(distance_sq)) + 1
        y0, x0 = max(ys[i] - r, 0), max(xs[i] - r, 0)
        win = blocked[y0:ys[i] + r + 1, x0:xs[i] + r + 1]
        win |= ((yy[y0:y0 + win.shape[0]] - ys[i]) ** 2
                + (xx[:, x0:x0 + win.shape[1]] - xs[i]) ** 2 < distance_sq)

    distance_sq = distance * distance
    i = 0
    k = len(candidates)
    while len(kept) < num_features:
        if not blocked[ys[i], xs[i]]:
            kept.append(i)
            block(i, distance_sq)
        i += 1
        if i == k:
            i = 0
            distance -= 1.0
            distance_sq = distance * distance
            blocked[:] = False
            for j in kept:
                block(j, distance_sq)
    return np.asarray(candidates)[kept].astype(np.int32)


def _select(cand: np.ndarray, num_features: int,
            distance: float) -> np.ndarray:
    if have_native():
        return native_host.select_scattered_features(cand, num_features,
                                                     distance)
    return select_scattered_features(cand, None, num_features, distance)


def _stable_sort_desc(scores: np.ndarray) -> np.ndarray:
    """Indices of a stable descending sort (std::stable_sort with
    score > rhs.score, linemod.hpp:98-101)."""
    return np.argsort(-scores, kind="stable")


def extract_gradient_template(angle_bits: np.ndarray, magnitude: np.ndarray,
                              mask: Optional[np.ndarray],
                              num_features: int,
                              strong_threshold: float) -> Optional[np.ndarray]:
    """ColorGradientPyramid::extractTemplate (linemod.cpp:461-513).

    Candidate = border pixel (mask minus its erosion) with a quantized
    orientation and squared magnitude above strong_threshold^2; greedy
    scattered selection with initial distance |candidates|/nf + 1.
    Returns (nf, 3) int32 or None if too few candidates.
    """
    if have_native():
        return native_host.extract_gradient_template(
            angle_bits, magnitude, mask, num_features, strong_threshold)
    if mask is not None:
        local_mask = mask.astype(bool) & ~_erode3_np(mask)
    else:
        local_mask = np.ones_like(angle_bits, bool)

    thr_sq = strong_threshold * strong_threshold
    sel = local_mask & (angle_bits > 0) & (magnitude > thr_sq)
    ys, xs = np.nonzero(sel)
    if len(ys) < num_features:
        return None
    labels = _LABEL_LUT[angle_bits[ys, xs]]
    order = _stable_sort_desc(magnitude[ys, xs])
    cand = np.stack([xs[order], ys[order], labels[order]], axis=-1)
    return _select(cand, num_features, float(len(cand) // num_features + 1))


def extract_normal_template(normal_bits: np.ndarray,
                            mask: Optional[np.ndarray],
                            num_features: int,
                            extract_threshold: int) -> Optional[np.ndarray]:
    """DepthNormalPyramid::extractTemplate (linemod.cpp:747-825).

    Per-label chessboard distance transforms and per-label count
    balancing, then greedy scattered selection with distance
    sqrt(area)/sqrt(nf) + 1.5.
    """
    if have_native():
        return native_host.extract_normal_template(
            normal_bits, mask, num_features, extract_threshold)
    local_mask = None if mask is None else _erode3_np(mask, iterations=2)
    h, w = normal_bits.shape
    distances = np.zeros((8, h, w), np.float32)
    for i in range(8):
        has_label = (normal_bits & (1 << i)) != 0
        if local_mask is not None:
            has_label &= local_mask
        distances[i] = _chamfer(has_label)

    sel_mask = np.ones((h, w), bool) if local_mask is None else local_mask
    ok = sel_mask & (normal_bits != 0) & (normal_bits != 255)
    ys, xs = np.nonzero(ok)
    labels = _LABEL_LUT[normal_bits[ys, xs]]
    scores = distances[labels, ys, xs]
    keep = scores >= extract_threshold
    ys, xs, labels, scores = ys[keep], xs[keep], labels[keep], scores[keep]
    if len(ys) < num_features:
        return None
    label_counts = np.bincount(labels, minlength=8).astype(np.float32)
    scores = scores / label_counts[labels]
    order = _stable_sort_desc(scores)
    cand = np.stack([xs[order], ys[order], labels[order]], axis=-1)
    area = float(h * w) if local_mask is None else float(local_mask.sum())
    return _select(cand, num_features,
                   float(np.sqrt(area) / np.sqrt(float(num_features)) + 1.5))


def crop_template_view(features: List[List[np.ndarray]]):
    """cropTemplates (linemod.cpp:52-96): common bbox over all levels and
    modalities (coords scaled by 2^level), even-aligned origin; shifts
    features in place.  Returns (width, height, offset_x, offset_y) lists
    per level plus the level-0 bounding box rect."""
    min_x = min_y = np.iinfo(np.int32).max
    max_x = max_y = np.iinfo(np.int32).min
    for l, mods in enumerate(features):
        for feats in mods:
            if len(feats) == 0:
                continue
            xs = feats[:, 0].astype(np.int64) << l
            ys = feats[:, 1].astype(np.int64) << l
            min_x = min(min_x, int(xs.min()))
            min_y = min(min_y, int(ys.min()))
            max_x = max(max_x, int(xs.max()))
            max_y = max(max_y, int(ys.max()))
    if min_x % 2 == 1:
        min_x -= 1
    if min_y % 2 == 1:
        min_y -= 1

    levels = len(features)
    width = [(max_x - min_x) >> l for l in range(levels)]
    height = [(max_y - min_y) >> l for l in range(levels)]
    off_x = [min_x >> l for l in range(levels)]
    off_y = [min_y >> l for l in range(levels)]
    for l, mods in enumerate(features):
        for feats in mods:
            feats[:, 0] -= off_x[l]
            feats[:, 1] -= off_y[l]
    return width, height, off_x, off_y, (min_x, min_y, max_x - min_x,
                                         max_y - min_y)


def _batch_crop_rects(masks, shape_hw, levels: int, margin: int = 16):
    """Per-view crop origins (y0, x0) plus ONE (ch, cw) covering every mask
    bbox + margin: the quantization's reach (7x7 blur, hysteresis vote,
    5x5 median, ring-5 plane fit) never exceeds ``margin``, so quantizing
    the crop equals quantizing the full frame at every candidate pixel.
    Origins align to ``2**(levels-1)`` so pyrDown block parity matches the
    full-frame pyramid."""
    h, w = shape_hw
    al = 1 << (levels - 1)
    rects = []
    ch = cw = 0
    for m in masks:
        ys, xs = np.nonzero(m)
        y0 = max(int(ys.min()) - margin, 0)
        x0 = max(int(xs.min()) - margin, 0)
        y1 = min(int(ys.max()) + 1 + margin, h)
        x1 = min(int(xs.max()) + 1 + margin, w)
        y0 -= y0 % al
        x0 -= x0 % al
        rects.append((y0, x0, y1, x1))
        ch = max(ch, y1 - y0)
        cw = max(cw, x1 - x0)
    # one crop size, 16-aligned (even dims at every pyramid level)
    ch = min(-(-ch // 16) * 16, h // al * al)
    cw = min(-(-cw // 16) * 16, w // al * al)
    out = []
    for (y0, x0, y1, x1) in rects:
        y0 = min(y0, h - ch)
        x0 = min(x0, w - cw)
        out.append((y0 - y0 % al, x0 - x0 % al))
    return out, (ch, cw)


def _quantize_levels(bgr: torch.Tensor, depth: torch.Tensor,
                     det: cfg.DetectorConfig) -> List[tuple]:
    """Per-level (angle bits u8, magnitude f32, normal bits u8) of views
    ``bgr`` (..., H, W, 3) u8 and ``depth`` (..., H, W) int32 on the
    device; each front-end op runs once over the leading (batch) axes.
    The ColorGradient modality re-quantizes a pyrDown'd image, DepthNormal
    nearest-downsamples its level-0 quantization."""
    cg, dn = det.color_gradient, det.depth_normal
    use_cg = "color_gradient" in det.modalities
    qdn = (q.quantize_normals(depth, dn.distance_threshold,
                              dn.difference_threshold)
           if "depth_normal" in det.modalities
           else torch.zeros(depth.shape, dtype=torch.uint8,
                            device=depth.device))
    out = []
    src = bgr
    for l in range(det.pyramid_levels):
        if l > 0:
            src = fi.pyr_down_u8(src)
            qdn = qdn[..., ::2, ::2]
        if use_cg:
            ab, mag = q.quantize_gradients(src, cg.weak_threshold)
        else:
            ab = torch.zeros(src.shape[:-1], dtype=torch.uint8,
                             device=src.device)
            mag = torch.zeros(src.shape[:-1], dtype=torch.float32,
                              device=src.device)
        out.append((ab, mag, qdn.contiguous()))
    return out


def _fetch(tensors: List[torch.Tensor]) -> List[np.ndarray]:
    """Every tensor to the host in ONE transfer (as raw bytes)."""
    flat = torch.cat([t.reshape(-1).view(torch.uint8) for t in tensors])
    host = flat.cpu().numpy()
    out, i = [], 0
    for t in tensors:
        n = t.numel() * t.element_size()
        dt = np.float32 if t.dtype == torch.float32 else np.uint8
        out.append(host[i:i + n].copy().view(dt).reshape(tuple(t.shape)))
        i += n
    return out


def quantize_crops(bgr_c: np.ndarray, dep_c: np.ndarray,
                   det: cfg.DetectorConfig, device) -> List[List[tuple]]:
    """Quantize N stacked crops (the counterpart of the JAX package's
    vmapped ``quantize_batch``): one upload, each level's front-end once
    over all N crops on the device, one fetch.  Returns ``levels[l][i] =
    (angle bits, magnitude, normal bits)`` as host arrays."""
    bgr_d = torch.from_numpy(np.ascontiguousarray(bgr_c, np.uint8)).to(device)
    dep_d = torch.from_numpy(np.asarray(dep_c, np.int32)).to(device)
    host = _fetch([t for lv in _quantize_levels(bgr_d, dep_d, det)
                   for t in lv])
    return [[tuple(a[i] for a in host[3 * l:3 * l + 3])
             for i in range(len(bgr_c))]
            for l in range(det.pyramid_levels)]


def _extract_view(qlevels, mask: Optional[np.ndarray], pose,
                  det: cfg.DetectorConfig, x0: int = 0,
                  y0: int = 0) -> Optional[TemplateView]:
    """Features of one view from its per-level quantizations
    (``qlevels[l] = (angle bits, magnitude, normal bits)``) and mask, with
    per-level halving of num_features and extract_threshold
    (linemod.cpp:434-452, 721-739); coordinates are shifted by the crop
    origin (x0, y0) back to frame coordinates."""
    cg, dn = det.color_gradient, det.depth_normal
    use_cg = "color_gradient" in det.modalities
    use_dn = "depth_normal" in det.modalities
    cg_nf, dn_nf = cg.num_features, dn.num_features
    dn_extract = dn.extract_threshold
    msk = mask
    features: List[List[np.ndarray]] = []
    for l in range(det.pyramid_levels):
        if l > 0:
            if msk is not None:
                msk = msk[::2, ::2]
            cg_nf //= 2
            dn_nf //= 2
            dn_extract //= 2
        ab, mag, qdn = qlevels[l]
        mods: List[np.ndarray] = []
        if use_cg:
            feats = extract_gradient_template(ab, mag, msk, cg_nf,
                                              cg.strong_threshold)
            if feats is None:
                return None
            mods.append(feats)
        if use_dn:
            feats = extract_normal_template(qdn, msk, dn_nf, dn_extract)
            if feats is None:
                return None
            mods.append(feats)
        for feats in mods:
            feats[:, 0] += x0 >> l
            feats[:, 1] += y0 >> l
        features.append(mods)
    width, height, off_x, off_y, _ = crop_template_view(features)
    return TemplateView(features=features, width=width, height=height,
                        offset_x=off_x, offset_y=off_y,
                        pose=np.asarray(pose, np.float32))


def crop_views(bgrs, depths, masks, levels: int):
    """The views' mask-bbox crops, all of one size (see
    :func:`_batch_crop_rects`): (origins [(y0, x0)], bgr (N, ch, cw, 3),
    depth (N, ch, cw), masks (N, ch, cw) bool)."""
    masks_np = [np.asarray(m).astype(bool) for m in masks]
    rects, (ch, cw) = _batch_crop_rects(masks_np, bgrs[0].shape[:2], levels)

    def crop(images):
        return np.stack([np.asarray(images[i])[y0:y0 + ch, x0:x0 + cw]
                         for i, (y0, x0) in enumerate(rects)])

    return rects, crop(bgrs), crop(depths), crop(masks_np)


def default_workers() -> int:
    """Host threads of :func:`extract_views` when none are given."""
    return min(os.cpu_count() or 4, 16)


def extract_views(qlevels, rects, msk_c, poses, det: cfg.DetectorConfig,
                  workers: Optional[int] = None
                  ) -> List[Optional[TemplateView]]:
    """The views of :func:`quantize_crops`' output (crop origins ``rects``
    and crop masks ``msk_c`` from :func:`crop_views`): the sequential
    greedy extraction (selectScatteredFeatures, linemod.cpp:135-164) fans
    out across host threads (the native helpers release the GIL)."""
    levels = det.pyramid_levels

    def extract_one(i: int) -> Optional[TemplateView]:
        y0, x0 = rects[i]
        return _extract_view([qlevels[l][i] for l in range(levels)],
                             msk_c[i], poses[i], det, x0, y0)

    have_native()      # load the library once, before the threads ask
    with cf.ThreadPoolExecutor(max_workers=workers or default_workers()
                               ) as pool:
        return list(pool.map(extract_one, range(len(rects))))


def add_templates_batched(bgrs, depths, masks, poses,
                          det: cfg.DetectorConfig, device="cuda",
                          workers: Optional[int] = None
                          ) -> List[Optional[TemplateView]]:
    """Batched :func:`add_template` over N views: every view's mask-bbox
    crop is quantized on ``device`` between one upload and one fetch, then
    the views are extracted on host threads (:func:`extract_views`).
    Produces views identical to :func:`add_template`: cropping preserves
    exactness (see :func:`_batch_crop_rects`)."""
    rects, bgr_c, dep_c, msk_c = crop_views(bgrs, depths, masks,
                                            det.pyramid_levels)
    qlevels = quantize_crops(bgr_c, dep_c, det, device)
    return extract_views(qlevels, rects, msk_c, poses, det, workers)


def add_template(bgr: np.ndarray, depth_mm: np.ndarray,
                 mask: Optional[np.ndarray], pose_13: np.ndarray,
                 det: cfg.DetectorConfig,
                 device="cuda") -> Optional[TemplateView]:
    """Full addTemplate for one view: a TemplateView, or None if any
    level/modality yields too few features (linemod.cpp:1599-1605).  The
    frame is quantized on ``device`` (one upload, one fetch)."""
    qlevels = quantize_crops(np.asarray(bgr)[None],
                             np.asarray(depth_mm).astype(np.uint16)[None], det,
                             device)
    msk = None if mask is None else np.asarray(mask).astype(bool)
    return _extract_view([lv[0] for lv in qlevels], msk, pose_13, det)
