"""Quantization front-end: colour-gradient orientations and depth normals
(counterpart of ``fealess_tpu.ops.quantize``).

- :func:`quantize_gradients` == ``quantizedOrientations`` +
  ``hysteresisGradient`` (linemod/linemod.cpp:230-385).
- :func:`quantize_normals` == ``quantizedNormals`` (linemod.cpp:595-685).

Outputs are u8 bitmask images: pixel value ``1 << label`` or 0.  Leading
axes before the image's are a batch (``training.quantize_crops`` runs all
of a chunk's crops in one call); a single image takes the same launches
as before batching was possible.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from fealess_tpu_torch.ops import image as fi

NEIGHBOR_THRESHOLD = 5  # 3x3 majority vote minimum (linemod.cpp:377)
NORMAL_RING_RADIUS = 5  # plane-fit ring radius (linemod.cpp:607)
NORMAL_GRANULARITY = 20  # normal_lut.i granularity


def _interior(h: int, w: int, lo: int, hi: int, device) -> torch.Tensor:
    """(h, w) bool: lo <= y < h - hi and lo <= x < w - hi (broadcasts
    over a batch's leading axes)."""
    yy = torch.arange(h, device=device)[:, None]
    xx = torch.arange(w, device=device)[None, :]
    return (yy >= lo) & (yy < h - hi) & (xx >= lo) & (xx < w - hi)


def quantize_gradients(src_bgr: torch.Tensor, weak_threshold: float):
    """Quantized gradient-orientation image of a u8 (..., H, W, 3) image.

    Returns ``(quantized, magnitude)``: the u8 bitmask image and the
    float32 squared-magnitude image.  Channel-argmax tie-breaks, the
    fastAtan2 polynomial, round-half-to-even bin rounding, border zeroing
    and the >=5-vote hysteresis follow linemod.cpp:230-385.
    """
    smoothed = fi.gaussian_blur7_u8(src_bgr)
    dx = fi.sobel3_i16(smoothed, "x").to(torch.int32)
    dy = fi.sobel3_i16(smoothed, "y").to(torch.int32)
    mag = dx * dx + dy * dy

    m0, m1, m2 = mag[..., 0], mag[..., 1], mag[..., 2]
    pick0 = (m0 >= m1) & (m0 >= m2)
    pick1 = (~pick0) & (m1 >= m0) & (m1 >= m2)

    def _take(a):
        return torch.where(pick0, a[..., 0],
                           torch.where(pick1, a[..., 1], a[..., 2]))

    sdx = _take(dx).to(torch.float32)
    sdy = _take(dy).to(torch.float32)
    magnitude = _take(mag).to(torch.float32)

    angle = fi.fast_atan2_deg(sdy, sdx)
    # convertTo(CV_8U, 16/360): cvRound = round-half-to-even (torch.round
    # rounds half to even, like jnp.rint), then &7.
    quant16 = torch.round(angle * (16.0 / 360.0)).to(torch.int32)
    h, w = angle.shape[-2:]
    interior = _interior(h, w, 1, 1, angle.device)
    quant8 = torch.where(interior, quant16 & 7, 0)

    # 3x3 label histogram (zero-padded borders vote label 0)
    onehot = (quant8[..., None] == torch.arange(8, device=angle.device)
              ).to(torch.int32)
    onehot_p = F.pad(onehot, (0, 0, 1, 1, 1, 1))
    hist = sum(onehot_p[..., r:r + h, c:c + w, :] for r in range(3)
               for c in range(3))
    # first maximum wins, like the reference's C scan
    votes = hist[..., 0]
    best = torch.zeros_like(votes)
    for k in range(1, 8):
        better = hist[..., k] > votes
        best = torch.where(better, k, best)
        votes = torch.where(better, hist[..., k], votes)

    strong = magnitude > np.float32(weak_threshold * weak_threshold)
    accept = interior & strong & (votes >= NEIGHBOR_THRESHOLD)
    quantized = torch.where(accept, torch.bitwise_left_shift(1, best), 0)
    return quantized.to(torch.uint8), magnitude


def _azimuth_bin_from_grid(ix: torch.Tensor, iy: torch.Tensor) -> torch.Tensor:
    """Sector bitmask ``1 << azimuth_bin`` of the NORMAL_LUT grid cell
    (ix, iy) in [0, 20)^2 by octant arithmetic (exact: sector boundaries
    have irrational slopes, so no integer grid point lies on one)."""
    dx = (ix - NORMAL_GRANULARITY // 2).to(torch.float32)
    dy = (iy - NORMAL_GRANULARITY // 2).to(torch.float32)
    ax, ay = dx.abs(), dy.abs()
    t = np.float32(0.41421356)            # tan 22.5deg
    q = (ay > ax * t).to(torch.int32) + (ay * t > ax).to(torch.int32)
    xn, yn = dx < 0, dy < 0
    bin8 = torch.where(yn, torch.where(xn, 4 + q, (8 - q) & 7),
                       torch.where(xn, 4 - q, q))
    return torch.bitwise_left_shift(1, bin8).to(torch.uint8)


def quantize_normals(depth_u16: torch.Tensor, distance_threshold: int,
                     difference_threshold: int) -> torch.Tensor:
    """Quantized surface-normal image of a (..., H, W) depth image in mm,
    after the reference's 5x5 median filter (linemod.cpp:595-685).  The
    depth is int32 (what the engine prepares) or any integer dtype that
    converts to int32 exactly (uint16, as the JAX package's name says;
    int16, uint8); leading axes are a batch of images."""
    h, w = depth_u16.shape[-2:]
    r = NORMAL_RING_RADIUS
    d = depth_u16.to(torch.int32)
    dpad = F.pad(d, (r, r, r, r))

    offsets = [(-r, -r), (0, -r), (r, -r), (-r, 0), (r, 0), (-r, r), (0, r),
               (r, r)]
    a00 = a01 = a11 = b0 = b1 = torch.zeros_like(d)
    for (i, j) in offsets:  # i = x offset, j = y offset (accumBilateral)
        nb = dpad[..., r + j:r + j + h, r + i:r + i + w]
        delta = nb - d
        f = (delta.abs() < difference_threshold).to(torch.int32)
        fi_, fj_ = f * i, f * j
        a00 = a00 + fi_ * i
        a01 = a01 + fi_ * j
        a11 = a11 + fj_ * j
        b0 = b0 + fi_ * delta
        b1 = b1 + fj_ * delta

    det = a00 * a11 - a01 * a01
    ddx = a11 * b0 - a01 * b1
    ddy = -a01 * b0 + a00 * b1

    # Magic 617 ~ focal length (linemod.cpp:650-653); exact int32 then f32.
    nx = (617 * ddx).to(torch.float32)
    ny = (617 * ddy).to(torch.float32)
    nz = (-det * d).to(torch.float32)
    norm = torch.sqrt(nx * nx + ny * ny + nz * nz)
    # true division (``1.0 / t`` in torch is reciprocal-then-multiply)
    inv = torch.where(norm > 0, torch.ones_like(norm) / norm, 0.0)
    g2 = NORMAL_GRANULARITY // 2
    ix = (nx * inv * g2 + g2).to(torch.int32).clamp(0, NORMAL_GRANULARITY - 1)
    iy = (ny * inv * g2 + g2).to(torch.int32).clamp(0, NORMAL_GRANULARITY - 1)
    sector = _azimuth_bin_from_grid(ix, iy)

    # Reference loop bounds: y in [r, H-r-1), x in [r, W-r-1) (linemod.cpp:619).
    interior = _interior(h, w, r, r + 1, d.device)
    valid = interior & (d < distance_threshold) & (norm > 0)
    quant = torch.where(valid, sector, 0).to(torch.uint8)
    return fi.median_blur5_u8(quant)


def apply_mask(quantized: torch.Tensor, mask) -> torch.Tensor:
    """``QuantizedPyramid::quantize`` masking (linemod.cpp:456-459/741-744)."""
    if mask is None:
        return quantized
    return torch.where(mask, quantized, 0).to(torch.uint8)
