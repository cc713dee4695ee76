"""Dynamic-window patch sampling with replicate borders (counterpart of
``fealess_tpu.ops.sampling``).

The reference tracker's crop + resize (``RectTools::subwindow`` with
BORDER_REPLICATE, then ``cv::resize`` bilinear, kcf_tracker/recttools.hpp:
115-131, kcftracker.cpp:416-419) as one clamped bilinear gather over the
whole image: output pixel j samples source coordinate
``x0 + (j + 0.5) * (src_w / out_w) - 0.5``, clamped to the image.  The
float32 formula is the JAX version's as XLA compiles it under ``jit``,
where the tracker calls it: a division by a constant becomes a
multiplication by its float32 reciprocal, and the CPU backend fuses
``a * b + c`` into one fused multiply-add (the left product of a sum).  The
port writes both out (:func:`fma` is exact in float64, on any device), so
it agrees bitwise with the jitted JAX function on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once: the product of two float32
    values is exact in float64."""
    return (a.double() * b + c).to(torch.float32)


def sample_patch_bilinear(image: torch.Tensor, x0, y0, src_w, src_h,
                          out_h: int, out_w: int) -> torch.Tensor:
    """Resample the ``src_h x src_w`` window at ``(x0, y0)`` to an
    ``(out_h, out_w, C)`` float32 patch.

    ``image`` is ``(H, W, C)`` or ``(H, W)``, any dtype.  ``x0, y0, src_w,
    src_h`` are float32 scalars, 0-d tensors for one window, or (B,)
    tensors for B windows, which give a (B, out_h, out_w, C) batch."""
    squeeze = image.dim() == 2
    img = (image[..., None] if squeeze else image).to(torch.float32)
    h, w = img.shape[:2]
    dev = img.device

    def axis(origin, size, n_out, n_img):
        origin, size = (torch.as_tensor(v, dtype=torch.float32, device=dev)
                        for v in (origin, size))
        step = size * float(np.float32(1.0) / np.float32(n_out))
        j = torch.arange(n_out, dtype=torch.float32, device=dev) + 0.5
        c = fma(j, step[..., None].double(), -0.5) + origin[..., None]
        c = c.clamp(0.0, n_img - 1.0)
        c0 = torch.floor(c)
        i0 = c0.to(torch.int64)
        return i0, (i0 + 1).clamp(max=n_img - 1), c - c0

    u0, u1, wu = axis(x0, src_w, out_w, w)
    v0, v1, wv = axis(y0, src_h, out_h, h)
    wu = wu[..., None, :, None]
    wv = wv[..., :, None, None]
    rows0, rows1 = v0[..., :, None], v1[..., :, None]
    cols0, cols1 = u0[..., None, :], u1[..., None, :]
    top = fma(img[rows0, cols0], 1.0 - wu, img[rows0, cols1] * wu)
    bot = fma(img[rows1, cols0], 1.0 - wu, img[rows1, cols1] * wu)
    out = fma(top, 1.0 - wv, bot * wv)
    return out[..., 0] if squeeze else out
