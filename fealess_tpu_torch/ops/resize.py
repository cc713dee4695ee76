"""``cv2.resize`` bit for bit, in integer torch ops (the camera-width
step of ``PrepareInputData``, CadReco/obj_reco_lmicp.cpp:216-259, which
the JAX package runs through cv2 on the host).

Both functions take a tensor on any device and return one on the same
device: on the card the frame is uploaded first and resized there.  The
per-axis index and coefficient tables are computed on the host (float32
and float64 exactly as ``cv::resize`` computes them) and kept per device.

:func:`resize_linear_u8` is INTER_LINEAR on u8 (``cv::resize``'s
fixed-point path, ``INTER_RESIZE_COEF_BITS`` = 11), found by experiment
against cv2 5.0.0 on every shape the tests list and on 1500 random ones
(1, 3 and 4 channels):

- per axis, ``scale = 1 / (dst / src)`` in float64, ``f = float32((d +
  0.5) * scale - 0.5)``, ``s = floor(f)``, ``f -= s``; coefficients
  ``rint(float32(1 - f) * 2048)`` and ``rint(f * 2048)``, each rounded on
  its own, so they may sum to 2047 or 2049;
- horizontally, a tap left of the image (``s < 0``) becomes ``s = 0, f =
  0`` and one at or past the last column ``s = W - 1, f = 0``: the
  horizontal pass is an exact integer sum ``c0 * p[s] + c1 * p[s + 1]``;
- vertically the border taps keep their fraction and both source rows
  are clipped into the image.  This is the 2-D upscale rule: only an
  upscale of the rows has taps outside the image (the first and last
  rows), and there the two rounded products below floor separately,
  which is 1 lower than the clamped form in ~0.1% of those rows' values;
- the vertical pass is cv2's SIMD form ``((b0 * (S0 >> 4)) >> 16) +
  ((b1 * (S1 >> 4)) >> 16) + 2) >> 2``.  Every intermediate fits in
  int32 (``2049 * 255 < 2**19``, ``2049 * 32655 < 2**27``).

An exact 2x downscale, which cv2 sends to INTER_AREA's fast path, gives
the rounded 2x2 mean ``(a + b + c + d + 2) >> 2`` by this rule as well
(coefficients 1024 and 1024), so it needs no path of its own.

:func:`resize_nearest` is INTER_NEAREST on any dtype: ``sx = min(floor(dx
* (1 / (dst / src))), src - 1)`` in float64, per axis.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

_COEF_SCALE = np.float32(2048)       # 1 << INTER_RESIZE_COEF_BITS


def _linear_taps(src: int, dst: int, clamp: bool):
    """(s0, s1, c0, c1) of one axis: source indices (int64) and their
    fixed-point weights (int32); ``clamp`` moves taps outside the image
    to the border with f = 0 (the horizontal rule)."""
    f = ((np.arange(dst) + 0.5) * (1.0 / (dst / src)) - 0.5).astype(
        np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp:
        f[s < 0] = 0
        s[s < 0] = 0
        f[s >= src - 1] = 0
        s[s >= src - 1] = src - 1
    c0 = np.rint((np.float32(1) - f) * _COEF_SCALE).astype(np.int32)
    c1 = np.rint(f * _COEF_SCALE).astype(np.int32)
    return (np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), c0, c1)


def _nearest_taps(src: int, dst: int) -> np.ndarray:
    return np.minimum(np.floor(np.arange(dst) * (1.0 / (dst / src))),
                      src - 1).astype(np.int64)


@functools.lru_cache(maxsize=32)
def _device_taps(kind: str, src: int, dst: int, device: torch.device):
    """One axis's tables as tensors on ``device`` (kept: a camera sends
    one size)."""
    if kind == "nearest":
        return torch.from_numpy(_nearest_taps(src, dst)).to(device)
    return tuple(torch.from_numpy(a).to(device)
                 for a in _linear_taps(src, dst, kind == "x"))


def resize_linear_u8(img: torch.Tensor,
                     size: Tuple[int, int]) -> torch.Tensor:
    """(H, W, C) u8 -> (h, w, C) u8 with ``size = (w, h)``, equal to
    ``cv2.resize(img, (w, h))`` (INTER_LINEAR; see the module
    docstring)."""
    w, h = size
    if img.dtype != torch.uint8 or img.dim() != 3:
        raise ValueError(f"resize_linear_u8 takes (H, W, C) u8, got "
                         f"{img.dtype} {tuple(img.shape)}")
    if (img.shape[0], img.shape[1]) == (h, w):
        return img.clone()
    x0, x1, a0, a1 = _device_taps("x", img.shape[1], w, img.device)
    y0, y1, b0, b1 = _device_taps("y", img.shape[0], h, img.device)
    src = img.to(torch.int32)
    a0, a1 = a0[:, None], a1[:, None]

    def rows(ys, beta):
        r = src.index_select(0, ys)
        hor = r.index_select(1, x0) * a0 + r.index_select(1, x1) * a1
        return ((hor >> 4) * beta[:, None, None]) >> 16

    return ((rows(y0, b0) + rows(y1, b1) + 2) >> 2).to(torch.uint8)


def resize_nearest(img: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(H, W) or (H, W, C) -> (h, w[, C]) of the same dtype with ``size =
    (w, h)``, equal to ``cv2.resize(img, (w, h), interpolation=
    cv2.INTER_NEAREST)``; depth is carried in int32."""
    w, h = size
    if (img.shape[0], img.shape[1]) == (h, w):
        return img.clone()
    ys = _device_taps("nearest", img.shape[0], h, img.device)
    xs = _device_taps("nearest", img.shape[1], w, img.device)
    return img.index_select(0, ys).index_select(1, xs)


def resize_host(img: np.ndarray, size: Tuple[int, int],
                nearest: bool = False) -> np.ndarray:
    """A host image resized to ``size = (w, h)`` on CPU tensors, as
    ``cv2.resize(img, size)`` (``nearest``: INTER_NEAREST, the dtype
    kept); an image already of that size is returned as it is."""
    w, h = size
    if img.shape[:2] == (h, w):
        return img
    if not nearest:
        return resize_linear_u8(torch.from_numpy(np.ascontiguousarray(
            img, np.uint8)), size).numpy()
    src = torch.from_numpy(np.asarray(img, np.int32))
    return resize_nearest(src, size).numpy().astype(img.dtype)
