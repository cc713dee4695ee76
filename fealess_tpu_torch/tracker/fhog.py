"""Felzenszwalb HOG (FHOG) features (counterpart of
``fealess_tpu.tracker.fhog``).

The latentsvm FHOG of the reference tracker (kcf_tracker/fhog.cpp):

- ``getFeatureMaps`` (fhog.cpp:80-275): per-pixel [-1, 0, 1] gradients,
  the channel with the largest magnitude wins (first max, as the
  reference's strict ``>``); the orientation goes to 1 of 9
  contrast-insensitive and 1 of 18 contrast-sensitive sectors by maximal
  (signed) dot product with the sector boundary vectors; magnitudes are
  shared bilinearly between the 2x2 nearest cells.  Image border pixels
  are excluded, as the reference's loop bounds do.
- ``normalizeAndTruncate`` (fhog.cpp:290-399): 4 diagonal 2x2 block norms
  of the insensitive energy, truncation at ``alfa``, outer cell ring
  cropped.
- ``PCAFeatureMaps`` (fhog.cpp:414-482): the analytic projection to 31
  dims.

Every function takes any number of leading batch dimensions before the
JAX version's (H, W, C) / (sy, sx, F) layout.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

NUM_SECTOR = 9          # fhog.hpp:91
TRUNCATION = 0.2        # kcftracker.cpp:428


def _cell_weights(k: int) -> np.ndarray:
    """Bilinear in-cell interpolation weights (fhog.cpp:190-207): for pixel
    row/col ``j`` within a cell, ``w[j, 0]`` is the own-cell weight and
    ``w[j, 1]`` the neighbour-cell weight."""
    w = np.zeros((k, 2), np.float32)
    for j in range(k // 2):
        b = k / 2 + j + 0.5
        a = k / 2 - j - 0.5
        w[j, 0] = 1.0 / a * ((a * b) / (a + b))
        w[j, 1] = 1.0 / b * ((a * b) / (a + b))
    for j in range(k // 2, k):
        a = j - k / 2 + 0.5
        b = -j + k / 2 - 0.5 + k
        w[j, 0] = 1.0 / a * ((a * b) / (a + b))
        w[j, 1] = 1.0 / b * ((a * b) / (a + b))
    return w


@functools.lru_cache()
def _boundary_vectors():
    ang = np.arange(NUM_SECTOR + 1) * (np.pi / NUM_SECTOR)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache()
def _constants(k: int, device: torch.device):
    """(cos, sin of the 9 sector boundaries, (k, 2) cell weights) on
    ``device``, uploaded once per device."""
    cosv, sinv = _boundary_vectors()
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (cosv[:NUM_SECTOR], sinv[:NUM_SECTOR],
                           _cell_weights(k)))


def raw_feature_maps(image: torch.Tensor, k: int) -> torch.Tensor:
    """getFeatureMaps: (..., H, W, C) float -> (..., H//k, W//k, 27)."""
    h, w = image.shape[-3], image.shape[-2]
    sy, sx = h // k, w // k
    dev = image.device

    # [-1, 0, 1] gradients with edge padding; the border rows/cols are
    # masked out below, so the padding mode does not matter
    xpad = torch.cat([image[..., :, :1, :], image, image[..., :, -1:, :]],
                     dim=-2)
    dx = xpad[..., :, 2:, :] - xpad[..., :, :-2, :]
    ypad = torch.cat([image[..., :1, :, :], image, image[..., -1:, :, :]],
                     dim=-3)
    dy = ypad[..., 2:, :, :] - ypad[..., :-2, :, :]

    mag = torch.sqrt(dx * dx + dy * dy)                  # (..., H, W, C)
    r = mag.amax(dim=-1, keepdim=True)
    best = mag.argmax(dim=-1, keepdim=True)             # first max wins
    gx = dx.gather(-1, best)
    gy = dy.gather(-1, best)

    cosv, sinv, wts = _constants(k, dev)
    dots = gx * cosv + gy * sinv                         # (..., H, W, 9)
    # the reference scans dot, then -dot, per sector with strict ``>``:
    # the winner is the FIRST max of the interleaved [d0, -d0, d1, ...]
    inter = torch.stack([dots, -dots], dim=-1).flatten(-2)
    idx = inter.argmax(dim=-1)
    maxi = idx // 2 + (idx % 2) * NUM_SECTOR             # sensitive 0..17
    ins = maxi % NUM_SECTOR                              # insensitive 0..8

    interior = torch.zeros((h, w), dtype=torch.bool, device=dev)
    interior[1:h - 1, 1:w - 1] = True
    r = torch.where(interior[..., None], r, 0.0)
    feat = torch.cat([F.one_hot(ins, NUM_SECTOR),
                      F.one_hot(maxi, 2 * NUM_SECTOR)],
                     dim=-1).to(torch.float32) * r       # (..., H, W, 27)

    lead = feat.shape[:-3]
    feat = feat[..., :sy * k, :sx * k, :].reshape(*lead, sy, k, sx, k,
                                                  3 * NUM_SECTOR)
    w0, w1 = wts[:, 0], wts[:, 1]
    half = k // 2

    # y-pass: own cell, then neighbour rows (first half -> cell above,
    # second half -> cell below; out-of-range contributions are dropped,
    # as the boundary guards at fhog.cpp:227-253)
    own_y = torch.einsum("...ykxjc,k->...yxjc", feat, w0)
    up = torch.einsum("...ykxjc,k->...yxjc", feat[..., :half, :, :, :],
                      w1[:half])
    dn = torch.einsum("...ykxjc,k->...yxjc", feat[..., half:, :, :, :],
                      w1[half:])
    ymaps = own_y.clone()
    ymaps[..., :-1, :, :, :] += up[..., 1:, :, :, :]
    ymaps[..., 1:, :, :, :] += dn[..., :-1, :, :, :]

    own_x = torch.einsum("...yxjc,j->...yxc", ymaps, w0)
    lf = torch.einsum("...yxjc,j->...yxc", ymaps[..., :half, :], w1[:half])
    rt = torch.einsum("...yxjc,j->...yxc", ymaps[..., half:, :], w1[half:])
    out = own_x.clone()
    out[..., :, :-1, :] += lf[..., :, 1:, :]
    out[..., :, 1:, :] += rt[..., :, :-1, :]
    return out


def normalize_and_truncate(maps: torch.Tensor,
                           alfa: float = TRUNCATION) -> torch.Tensor:
    """(..., sy, sx, 27) -> (..., sy-2, sx-2, 108), fhog.cpp:290-399."""
    p = NUM_SECTOR
    ins = maps[..., :p]
    sens = maps[..., p:]
    pn = (ins * ins).sum(dim=-1)                        # (..., sy, sx)

    def at(dy: int, dx: int):
        sy, sx = pn.shape[-2], pn.shape[-1]
        return pn[..., 1 + dy:sy - 1 + dy, 1 + dx:sx - 1 + dx]

    # diagonal 2x2 block norms around each interior cell, in the order of
    # fhog.cpp:326-380: A=(+,+), B=(-,+), C=(+,-), D=(-,-)
    c, rgt, lft, dwn, up = at(0, 0), at(0, 1), at(0, -1), at(1, 0), at(-1, 0)
    eps = float(np.finfo(np.float32).eps)
    na = torch.sqrt(c + rgt + dwn + at(1, 1)) + eps
    nb = torch.sqrt(c + rgt + up + at(-1, 1)) + eps
    nc = torch.sqrt(c + lft + dwn + at(1, -1)) + eps
    nd = torch.sqrt(c + lft + up + at(-1, -1)) + eps

    ins_c = ins[..., 1:-1, 1:-1, :]
    sens_c = sens[..., 1:-1, 1:-1, :]
    norms = [n[..., None] for n in (na, nb, nc, nd)]
    out = torch.cat([ins_c / n for n in norms] + [sens_c / n for n in norms],
                    dim=-1)                             # (..., 108)
    return out.clamp(max=alfa)


def pca_feature_maps(maps108: torch.Tensor) -> torch.Tensor:
    """(..., sy, sx, 108) -> (..., sy, sx, 31), fhog.cpp:414-482."""
    p = NUM_SECTOR
    lead = maps108.shape[:-1]
    ins4 = maps108[..., :4 * p].reshape(*lead, 4, p)
    sens4 = maps108[..., 4 * p:].reshape(*lead, 4, 2 * p)
    ny = 1.0 / np.sqrt(4.0)
    nx = 1.0 / np.sqrt(2.0 * p)
    part_sens = sens4.sum(dim=-2) * ny                  # (..., 18)
    part_ins = ins4.sum(dim=-2) * ny                    # (..., 9)
    part_norm = sens4.sum(dim=-1) * nx                  # (..., 4)
    return torch.cat([part_sens, part_ins, part_norm], dim=-1)


def fhog31(image: torch.Tensor, cell_size: int) -> torch.Tensor:
    """Full FHOG: (..., H, W, C) float -> (..., H//k - 2, W//k - 2, 31)."""
    return pca_feature_maps(
        normalize_and_truncate(raw_feature_maps(image, cell_size)))
