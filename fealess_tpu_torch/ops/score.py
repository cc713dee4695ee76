"""LINE-MOD sparse template scores: the coarse whole-image scorer (K1) and
the local 16x16 refinement scorer (K2) (counterpart of
``fealess_tpu.ops.score_pallas``).

Each wrapper launches its CUDA kernel (``csrc/score.cu``) for CUDA tensors
and runs its plain PyTorch twin only for CPU tensors; the twins keep the
arithmetic of the JAX package's XLA contracts (``_coarse_scores_xla``,
``_local_scores_xla``) and are what the CPU tests hold against JAX and
what the card's smoke run holds the kernels against.

Tables are the per-level entries of ``detector.build_match_tables``:
``c``/``ry``/``rx`` (N, F) int32 feature channel and decimated offsets,
valid features first; ``bstart`` (N, NB+1) int32 whose last column is the
number of valid features.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fealess_tpu_torch.ops import _build

LOCAL_WINDOW = 16   # 16x16 decimated refinement patch (linemod.cpp:1243)
_TABLE_KEYS = ("c", "ry", "rx", "bstart")
_MAX_FEATURES = 4096


def coarse_scores_plain(planes: torch.Tensor, table) -> torch.Tensor:
    """Twin of K1: per-feature window gathers of the zero-padded planes."""
    c, hd, wd = planes.shape
    nb = table["bstart"].shape[1] - 1
    padded = F.pad(planes.to(torch.int32), (0, nb, 0, nb))
    n, nf = table["c"].shape
    nvalid = table["bstart"][:, -1]
    dev = planes.device
    rows = torch.arange(hd, device=dev)[None, :, None]
    cols = torch.arange(wd, device=dev)[None, None, :]
    acc = torch.zeros((n, hd, wd), dtype=torch.int32, device=dev)
    for f in range(nf):
        sl = padded[table["c"][:, f, None, None],
                    table["ry"][:, f, None, None] + rows,
                    table["rx"][:, f, None, None] + cols]
        acc += torch.where((f < nvalid)[:, None, None], sl, 0)
    return acc


def local_scores_plain(planes: torch.Tensor, table_k, px0: torch.Tensor,
                       py0: torch.Tensor) -> torch.Tensor:
    """Twin of K2: per-feature 16x16 window gathers with the gating of
    ``_local_prepare``: origins clamped non-negative, features whose row
    start is outside [0, Hd] or past the valid count redirected to an
    all-zero channel, column start ``min(px0c + rx, Wd)``."""
    c, hd, wd = planes.shape
    w16 = LOCAL_WINDOW
    nb = table_k["bstart"].shape[1] - 1
    padded = F.pad(planes.to(torch.int32), (0, nb + w16, 0, w16, 0, 1))
    px0c = px0.clamp(min=0)
    py0c = py0.clamp(min=0)
    a = py0c[:, None] + table_k["ry"]
    ok = (a >= 0) & (a <= hd)
    k, nf = a.shape
    dev = planes.device
    live = torch.arange(nf, device=dev)[None, :] < table_k["bstart"][:, -1:]
    keep = ok & live
    cc = torch.where(keep, table_k["c"], c)
    ac = torch.where(keep, a, 0)
    bc = (px0c[:, None] + table_k["rx"]).clamp(max=wd)
    win = torch.arange(w16, device=dev)
    acc = torch.zeros((k, w16, w16), dtype=torch.int32, device=dev)
    for f in range(nf):
        acc += padded[cc[:, f, None, None],
                      ac[:, f, None, None] + win[None, :, None],
                      bc[:, f, None, None] + win[None, None, :]]
    return acc


def _require_table(table, rows: int, device) -> None:
    for key in _TABLE_KEYS:
        _build.require(table[key], f"table[{key!r}]", torch.int32, 2, device)
        if table[key].shape[0] != rows:
            raise ValueError(f"table[{key!r}] has {table[key].shape[0]} rows,"
                             f" expected {rows}")
    if table["c"].shape != table["ry"].shape or \
            table["c"].shape != table["rx"].shape:
        raise ValueError("table c/ry/rx shapes differ")
    if table["c"].shape[1] > _MAX_FEATURES:
        # the kernels stage a table row in dynamic shared memory, which is
        # limited to 48 KB without an opt-in
        raise ValueError(f"{table['c'].shape[1]} features per row exceed "
                         f"{_MAX_FEATURES}")


def _require_cuda(planes: torch.Tensor, name: str) -> None:
    if planes.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {planes.device}")


def coarse_scores(planes: torch.Tensor, table) -> torch.Tensor:
    """(N, Hd, Wd) int32 whole-image raw scores at the coarse level
    (``similarity``, linemod.cpp:1130-1214, zero-padded beyond the image).

    ``planes``: (C, Hd, Wd) u8 decimated responses (values 0..4).  CUDA
    tensors run kernel K1; CPU tensors run :func:`coarse_scores_plain`.
    """
    if planes.device.type == "cpu":
        return coarse_scores_plain(planes, table)
    _require_cuda(planes, "coarse_scores")
    dev = planes.device
    _build.require(planes, "planes", torch.uint8, 3, dev)
    n, nf = table["c"].shape
    _require_table(table, n, dev)
    _, hd, wd = planes.shape
    out = torch.empty((n, hd, wd), dtype=torch.int32, device=dev)
    if n == 0 or hd * wd == 0:
        return out.zero_()
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.fl_coarse_scores(
            planes.data_ptr(), hd, wd, table["c"].data_ptr(),
            table["ry"].data_ptr(), table["rx"].data_ptr(),
            table["bstart"].data_ptr(), n, nf, table["bstart"].shape[1],
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "coarse_scores")
    coarse_scores.launches += 1
    return out


coarse_scores.launches = 0


def local_scores(planes: torch.Tensor, table_k, px0: torch.Tensor,
                 py0: torch.Tensor) -> torch.Tensor:
    """(K, 16, 16) int32 window scores around refinement candidates
    (``similarityLocal``, linemod.cpp:1226-1300).

    ``planes``: (C, Hd, Wd) u8; ``table_k``: the candidates' table rows
    (K, F) / (K, NB+1); ``px0``/``py0``: (K,) int32 decimated window
    origins (negative only for degenerate clamps).  CUDA tensors run
    kernel K2; CPU tensors run :func:`local_scores_plain`.
    """
    if planes.device.type == "cpu":
        return local_scores_plain(planes, table_k, px0, py0)
    _require_cuda(planes, "local_scores")
    dev = planes.device
    _build.require(planes, "planes", torch.uint8, 3, dev)
    k, nf = table_k["c"].shape
    _require_table(table_k, k, dev)
    for name, t in (("px0", px0), ("py0", py0)):
        _build.require(t, name, torch.int32, 1, dev)
        if t.shape[0] != k:
            raise ValueError(f"{name} has {t.shape[0]} entries, expected {k}")
    _, hd, wd = planes.shape
    w16 = LOCAL_WINDOW
    out = torch.empty((k, w16, w16), dtype=torch.int32, device=dev)
    if k == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.fl_local_scores(
            planes.data_ptr(), hd, wd, table_k["c"].data_ptr(),
            table_k["ry"].data_ptr(), table_k["rx"].data_ptr(),
            table_k["bstart"].data_ptr(), k, nf, table_k["bstart"].shape[1],
            px0.data_ptr(), py0.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "local_scores")
    local_scores.launches += 1
    return out


local_scores.launches = 0
