"""Bounds of the port's kernels: the least time one H100 could take for a
kernel's work on given inputs, the yardstick that ``chip_smoke.py`` and
``apps/kernel_lab`` set each measured time beside.  Nothing on a serving
path imports this module."""

from __future__ import annotations

import torch

from fealess_tpu_torch.ops import lab, score

# Published peaks of one H100 SXM at 700 W (NVIDIA's H100 datasheet): HBM
# bytes per second, non-tensor f32 operations per second (the integer adds
# of the scorers are counted at the same CUDA-core rate) and dense TF32
# tensor-core operations per second.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12

NN_EPILOGUE_OPS = 2   # L4 a pair on the CUDA cores: a compare and a
# select (the norms, the -2 and the subtraction can ride in the product)
NN_DOT_OPS = 3 * 2 * 3   # L4 a pair: three TF32 passes of a 3-long dot


def _size(ts) -> int:
    return sum(t.numel() * t.element_size() for a in ts
               for t in (a.values() if isinstance(a, dict) else [a]))


def _coarse_count(planes, table) -> tuple:
    """K1's work: (bytes: planes and table read, scores written; one add
    per live feature and output position)."""
    n, nf = table["c"].shape
    nbytes = _size([planes, table]) + n * planes.shape[1] * \
        planes.shape[2] * 4
    ops = int(table["bstart"][:, -1].clamp(max=nf).sum()) * \
        planes.shape[1] * planes.shape[2]
    return nbytes, ops


def _local_count(planes, table, px0, py0) -> tuple:
    """K2's work at given origins: one add per plane byte that a live
    feature's 16x16 window reads (its row start on the plane, as the
    kernel gates it); of the planes only the distinct (channel, row,
    column) bytes those windows read."""
    k, nf = table["c"].shape
    _, hd, wd = planes.shape
    a = py0.clamp(min=0)[:, None] + table["ry"]
    b = (px0.clamp(min=0)[:, None] + table["rx"]).clamp(max=wd)
    live = torch.arange(nf, device=a.device)[None, :] < \
        table["bstart"][:, -1:]
    keep = (a >= 0) & (a <= hd) & live
    win = torch.arange(score.LOCAL_WINDOW, device=a.device)
    y = a[keep][:, None, None] + win[None, :, None]
    x = b[keep][:, None, None] + win[None, None, :]
    on = (y < hd) & (x >= 0) & (x < wd)
    cell = (table["c"][keep][:, None, None].long() * hd + y) * wd + x
    nbytes = (_size([table]) + k * score.LOCAL_WINDOW ** 2 * 4 +
              int(torch.unique(cell[on]).numel()) * planes.element_size())
    return nbytes, int(on.sum())


def bound_ms(name: str, args) -> tuple:
    """(ms, "bytes" or "operations"): the least time the card could take
    for the work of the kernel ``name`` (a wrapper of ``ops/score``,
    ``ops/nn`` or ``ops/lab``) on ``args``, the larger of its bytes (each
    input read once, each output written once) over HBM_BYTES_PER_S and
    its operations over the peak rate of their type, counted on these
    inputs.  K1 ``coarse_scores``, L1 ``coarse_variant`` (every mode but
    ``halftrip``, which counts the features it walks) and L2
    ``coarse_stride2``: one integer add per live feature and output
    position (:func:`_coarse_count`).  K2 ``local_scores`` / ``local_refine``
    and L3 ``local_variant``: :func:`_local_count`; the fused
    ``local_refine`` also reads its slots, positions and bank entries and
    writes 4 int32 a candidate.  K3 ``nearest_neighbor``: 8 f32
    operations a pair.  L4 ``nn_mxu``: the least work of any form, the
    larger of the dot at float32 accuracy (NN_DOT_OPS TF32 operations a
    pair at TF32_OPS_PER_S) and NN_EPILOGUE_OPS f32 operations a pair (a
    compare and a select)."""
    t_ops = None
    if name == "nearest_neighbor":
        q, r = args[:2]
        nbytes = _size([q, r]) + q.shape[0] * 8       # idx i32 + d2 f32
        t_ops = 8 * q.shape[0] * r.shape[0] / F32_OPS_PER_S
    elif name == "nn_mxu":
        q, r = args[:2]
        pairs = q.shape[0] * r.shape[0]
        nbytes = _size([q, r]) + q.shape[0] * 8
        t_ops = max(NN_EPILOGUE_OPS * pairs / F32_OPS_PER_S,
                    NN_DOT_OPS * pairs / TF32_OPS_PER_S)
    elif name == "coarse_variant" and args[2:3] == ("halftrip",):
        planes, table = args[:2]
        nbytes = _coarse_count(planes, table)[0]
        ops = _coarse_count(planes, lab.walked_table(
            table, table["bstart"], half=True))[1]
    elif name in ("coarse_scores", "coarse_variant", "coarse_stride2"):
        nbytes, ops = _coarse_count(*args[:2])
    elif name == "local_refine":
        planes, table, tslot, x, y, width, height, _, level, t, _, hw = args
        table_k, px0, py0, _, _ = score.local_window_inputs(
            table, tslot, x, y, width, height, level, t, hw)
        nbytes, ops = _local_count(planes, table_k, px0, py0)
        # slots, positions, 3 bank entries in; x, y, best, nf out
        nbytes += _size([tslot, x, y]) + tslot.shape[0] * 7 * 4
    elif name in ("local_scores", "local_variant"):
        planes, table, px0, py0 = args[:4]
        nbytes, ops = _local_count(planes, table, px0, py0)
        nbytes += _size([px0, py0])
    else:
        raise ValueError(f"no bound for kernel {name!r}")
    if t_ops is None:
        t_ops = ops / F32_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")
