"""Image primitives of the quantization front-end (counterpart of
``fealess_tpu.ops.image``).

Each reproduces the exact arithmetic of the OpenCV call the reference uses
(and of the JAX version): integer paths keep OpenCV's int32 fixed-point
scheme, so outputs are bit-exact.  Borders are built with index clamping
(replicate) or reflection (reflect-101) so every dtype works.
"""

from __future__ import annotations

import numpy as np
import torch

# OpenCV's fixed small Gaussian kernel for ksize=7, sigma=0:
# [4,14,28,36,28,14,4]/128, x2 for 8-bit fixed point per axis.
_GAUSS7 = (8, 28, 56, 72, 56, 28, 8)
_PYR5 = (1, 4, 6, 4, 1)


def _pad_index(n: int, r: int, mode: str, device) -> torch.Tensor:
    idx = torch.arange(-r, n + r, device=device)
    if mode == "replicate":
        return idx.clamp(0, n - 1)
    idx = idx.abs()                                   # reflect-101
    return torch.where(idx > n - 1, 2 * (n - 1) - idx, idx)


def _pad(x: torch.Tensor, r: int, axis: int, mode: str) -> torch.Tensor:
    return x.index_select(axis, _pad_index(x.shape[axis], r, mode, x.device))


def _sep_filter_int(x: torch.Tensor, kernel, mode: str) -> torch.Tensor:
    """Separable integer filter over axes 0 and 1; raw int32 accumulator."""
    r = len(kernel) // 2
    xp = _pad(x.to(torch.int32), r, 0, mode)
    h, w = x.shape[0], x.shape[1]
    acc = torch.zeros_like(x, dtype=torch.int32)
    for i, k in enumerate(kernel):
        acc = acc + k * xp.narrow(0, i, h)
    xp = _pad(acc, r, 1, mode)
    acc = torch.zeros_like(acc)
    for i, k in enumerate(kernel):
        acc = acc + k * xp.narrow(1, i, w)
    return acc


def gaussian_blur7_u8(img: torch.Tensor) -> torch.Tensor:
    """``GaussianBlur(src, dst, Size(7,7), 0, 0, BORDER_REPLICATE)`` of a
    u8 (H, W[, C]) image (linemod.cpp:247), 8-bit fixed point per axis,
    combined shift 16 with round-half-up."""
    acc = _sep_filter_int(img, _GAUSS7, "replicate")
    return ((acc + (1 << 15)) >> 16).to(torch.uint8)


def sobel3_i16(img: torch.Tensor, axis: str) -> torch.Tensor:
    """3x3 Sobel derivative of a u8 image into int16, BORDER_REPLICATE
    (linemod.cpp:248-249).  ``axis`` is "x" or "y"."""
    deriv, smooth = (-1, 0, 1), (1, 2, 1)
    kr, kc = (smooth, deriv) if axis == "x" else (deriv, smooth)
    x = img.to(torch.int32)
    h, w = img.shape[0], img.shape[1]
    xp = _pad(x, 1, 0, "replicate")
    acc = sum(k * xp.narrow(0, i, h) for i, k in enumerate(kr))
    xp = _pad(acc, 1, 1, "replicate")
    acc = sum(k * xp.narrow(1, i, w) for i, k in enumerate(kc))
    return acc.to(torch.int16)


def _even_odd(x: torch.Tensor, axis: int):
    v = x.unflatten(axis, (x.shape[axis] // 2, 2))
    return v.select(axis + 1, 0), v.select(axis + 1, 1)


def _pyr5_axis_even(x: torch.Tensor, axis: int) -> torch.Tensor:
    """[1,4,6,4,1] along ``axis``, BORDER_REFLECT_101, at even output
    positions only: out[y] = e[y-1] + 4 o[y-1] + 6 e[y] + 4 o[y] + e[y+1]
    with e/o the even/odd input rows.  Reflect-101 fills the edges:
    e[-1] = x[-2] = x[2] = e[1], o[-1] = x[-1] = x[1] = o[0] and
    e[n] = x[H] = x[H-2] = e[n-1]."""
    e, o = _even_odd(x, axis)
    n = e.shape[axis]
    e_prev = torch.cat([e.narrow(axis, 1, 1), e.narrow(axis, 0, n - 1)], axis)
    e_next = torch.cat([e.narrow(axis, 1, n - 1), e.narrow(axis, n - 1, 1)],
                       axis)
    o_prev = torch.cat([o.narrow(axis, 0, 1), o.narrow(axis, 0, n - 1)], axis)
    return e * 6 + (o_prev + o) * 4 + e_prev + e_next


def pyr_down_u8(img: torch.Tensor) -> torch.Tensor:
    """OpenCV ``pyrDown`` of a u8 (H, W[, C]) image to half size
    (linemod.cpp:441): [1,4,6,4,1]/16 per axis in integer fixed point
    (combined /256, round-half-up), BORDER_REFLECT_101.  H, W even."""
    x = img.to(torch.int32)
    acc = _pyr5_axis_even(_pyr5_axis_even(x, 0), 1)
    return ((acc + 128) >> 8).to(torch.uint8)


def _box5_sum_i32(x: torch.Tensor) -> torch.Tensor:
    h, w = x.shape
    xp = _pad(x, 2, 0, "replicate")
    acc = sum(xp.narrow(0, i, h) for i in range(5))
    xp = _pad(acc, 2, 1, "replicate")
    return sum(xp.narrow(1, i, w) for i in range(5))


def median_blur5_u8(img: torch.Tensor) -> torch.Tensor:
    """``medianBlur(dst, dst, 5)`` of a u8 bitmask image whose pixels lie
    in {0} | {1<<k} (linemod.cpp:684): the smallest value v whose window
    count of pixels <= v reaches 13 of 25, BORDER_REPLICATE."""
    values = [0] + [1 << k for k in range(8)]
    x = img.to(torch.int32)
    med = torch.full(img.shape, values[-1], dtype=torch.int32,
                     device=img.device)
    for v in reversed(values[:-1]):
        cnt = _box5_sum_i32((x <= v).to(torch.int32))
        med = torch.where(cnt >= 13, v, med)
    return med.to(torch.uint8)


def fast_atan2_deg(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """OpenCV ``cv::fastAtan2`` polynomial in float32 (linemod.cpp:303):
    degrees in [0, 360), the same operation order as the JAX version."""
    def f32(v):
        return torch.tensor(np.float32(v), device=x.device)

    p1 = f32(np.degrees(0.9997878412794807))
    p3 = f32(np.degrees(-0.3258083974640975))
    p5 = f32(np.degrees(0.1555786518463281))
    p7 = f32(np.degrees(-0.04432655554792128))
    eps = f32(1.1920929e-07)  # FLT_EPSILON
    ax, ay = x.abs(), y.abs()
    big = ax >= ay
    c = torch.where(big, ay / (ax + eps), ax / (ay + eps))
    c2 = c * c
    poly = (((p7 * c2 + p5) * c2 + p3) * c2 + p1) * c
    a = torch.where(big, poly, 90.0 - poly)
    a = torch.where(x < 0, 180.0 - a, a)
    return torch.where(y < 0, 360.0 - a, a)
