"""Spread-binarized orientations and decimated response planes
(counterpart of the decimate-first path of ``fealess_tpu.ops.response``).

The quantized bitmask image is first split into its T x T residue
subgrids, the T x T OR-spread is computed on those subgrids, and the
per-orientation responses 0..4 follow from the spread byte by bit
arithmetic — the reference's linear memories (linemod.cpp:882-1117) on a
2D grid, ``(8*T*T, H/T, W/T)`` per modality.
"""

from __future__ import annotations

import importlib.util
import pathlib

import torch

import fealess_tpu


def _orientation_scores():
    """``ORIENTATION_SCORES`` of fealess_tpu/ops/luts.py.  That module is
    numpy-only, but importing it as ``fealess_tpu.ops.luts`` would run
    ``fealess_tpu/ops/__init__.py``, which imports jax; so the file is
    loaded on its own."""
    path = pathlib.Path(fealess_tpu.__file__).parent / "ops" / "luts.py"
    spec = importlib.util.spec_from_file_location("_fealess_tpu_luts", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.ORIENTATION_SCORES


ORIENTATION_SCORES = _orientation_scores()


def decimate_quant(quant: torch.Tensor, t: int) -> torch.Tensor:
    """(H, W) image -> (T*T, H/T, W/T) subgrids, channel a*T + b =
    quant[a::T, b::T]."""
    h, w = quant.shape
    if h % t or w % t:
        raise ValueError(f"image {h}x{w} is not divisible by T={t}")
    x = quant.reshape(h // t, t, w // t, t)
    return x.permute(1, 3, 0, 2).reshape(t * t, h // t, w // t)


def _or_scan_shift(q: torch.Tensor, t: int, res_axis: int, sp_axis: int
                   ) -> torch.Tensor:
    """One separable pass of the decimated spread: for output residue a,
    ``out[a] = suffix_or(q)[a] | next(prefix_or(q)[a])``, where the
    prefix/suffix ORs run over ``res_axis`` and ``next`` reads the next
    decimated row/col along ``sp_axis`` (zero past the edge)."""
    qs = q.movedim(res_axis, 0)
    suf = [qs[t - 1]]
    for a in range(t - 2, -1, -1):
        suf.insert(0, qs[a] | suf[0])
    pre = [torch.zeros_like(qs[0])]
    for a in range(1, t):
        pre.append(pre[-1] | qs[a - 1])

    sp = sp_axis if sp_axis < res_axis else sp_axis - 1  # axis in qs[a]
    n = qs.shape[1 + sp]

    def nxt(x):
        body = x.narrow(sp, 1, n - 1)
        return torch.cat([body, torch.zeros_like(x.narrow(sp, 0, 1))], sp)

    out = torch.stack([suf[a] | nxt(pre[a]) for a in range(t)])
    return out.movedim(0, res_axis)


def spread_decimated(q_dec: torch.Tensor, t: int) -> torch.Tensor:
    """(T, T, Hd, Wd) decimated quant subgrids -> decimated SPREAD subgrids
    (the full-resolution T x T OR-spread sampled at the subgrid positions)."""
    rows = _or_scan_shift(q_dec, t, res_axis=0, sp_axis=2)
    return _or_scan_shift(rows, t, res_axis=1, sp_axis=3)


def _response_stack_i32(spread_img: torch.Tensor) -> torch.Tensor:
    """(8, ...) i32 responses from a spread bitmask: for orientation o, the
    score of the closest set bit by circular distance (SIMILARITY_LUT's
    generating rule, linemod.cpp:970)."""
    b = spread_img.to(torch.int32)

    def rot(x, k):
        return ((x << k) | (x >> (8 - k))) & 0xFF

    m1 = rot(b, 1) | rot(b, 7)
    m2 = m1 | rot(b, 2) | rot(b, 6)
    s4, s2, s1 = ORIENTATION_SCORES[0], ORIENTATION_SCORES[1], \
        ORIENTATION_SCORES[2]
    zero = torch.zeros_like(b)
    return torch.stack(
        [torch.where(((b >> o) & 1) == 1, s4,
                     torch.where(((m1 >> o) & 1) == 1, s2,
                                 torch.where(((m2 >> o) & 1) == 1, s1, zero)))
         for o in range(8)])


def build_level_2d(quantized: torch.Tensor, t: int) -> torch.Tensor:
    """Quantized bitmask image -> (8*T*T, H/T, W/T) i32 decimated responses
    (values 0..4), channel ``label*T*T + a*T + b``."""
    h, w = quantized.shape
    hd, wd = h // t, w // t
    q = quantized.to(torch.int32)
    q_dec = decimate_quant(q, t).reshape(t, t, hd, wd)
    b = spread_decimated(q_dec, t).reshape(t * t, hd, wd)
    return _response_stack_i32(b).reshape(8 * t * t, hd, wd)
