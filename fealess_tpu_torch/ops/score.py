"""LINE-MOD sparse template scores: the coarse whole-image scorer (K1) and
the local 16x16 refinement scorer (K2) (counterpart of
``fealess_tpu.ops.score_pallas``).

Each wrapper launches its CUDA kernel (``csrc/score.cu``) for CUDA tensors
and runs its plain PyTorch twin only for CPU tensors; the twins keep the
arithmetic of the JAX package's XLA contracts (``_coarse_scores_xla``,
``_local_scores_xla``) and are what the CPU tests hold against JAX and
what the card's smoke run holds the kernels against.  K2 has two entries
on one kernel: :func:`local_scores` (window sums at given origins) and
:func:`local_refine` (one whole refinement level of the detector: clamp,
origins, window sums and the first-maximum epilogue in one launch).

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
_MAX_OFFSET = 8191   # table offsets rx, ry lie in [0, NB) with NB <= this


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


def local_window_inputs(table, tslot: torch.Tensor, x: torch.Tensor,
                        y: torch.Tensor, width: torch.Tensor,
                        height: torch.Tensor, level: int, t: int, size):
    """One refinement level's K2 inputs (linemod.cpp:1509-1534): the
    candidates' level-(l+1) positions clamped at level ``level`` (the
    lower bound wins for a template bigger than the search area), their
    16x16 window origins and their table rows.  Returns (table_k, px0,
    py0, x, y)."""
    h, w = size
    border = 8 * t
    x = torch.clamp(torch.minimum(x * 2 + 1, w - width[tslot, level] - border),
                    min=border)
    y = torch.clamp(torch.minimum(y * 2 + 1,
                                  h - height[tslot, level] - border),
                    min=border)
    px0 = (x // t - 8).to(torch.int32)
    py0 = (y // t - 8).to(torch.int32)
    table_k = {key: v.index_select(0, tslot) for key, v in table.items()}
    return table_k, px0, py0, x, y


def local_refine_plain(planes: torch.Tensor, table, tslot: torch.Tensor,
                       x: torch.Tensor, y: torch.Tensor, width: torch.Tensor,
                       height: torch.Tensor, nfeat: torch.Tensor, level: int,
                       t: int, offset: int, size):
    """Twin of the fused K2: :func:`local_window_inputs`,
    :func:`local_scores_plain` and the epilogue of matchClass
    (linemod.cpp:1540-1566): the first maximum in row-major order
    (``jnp.argmax``'s rule) moves x and y to its cell."""
    table_k, px0, py0, x, y = local_window_inputs(table, tslot, x, y, width,
                                                  height, level, t, size)
    scores = local_scores_plain(planes, table_k, px0, py0)
    win = LOCAL_WINDOW
    flat = scores.reshape(-1, win * win)
    best = flat.max(dim=1).values
    best_idx = flat.argmax(dim=1)
    x = ((x // t - 8 + best_idx % win) * t + offset).to(torch.int32)
    y = ((y // t - 8 + best_idx // win) * t + offset).to(torch.int32)
    return scores, x, y, best, nfeat[tslot, level]


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


def _require_32bit(planes: torch.Tensor, name: str) -> None:
    if planes.numel() >= 2 ** 31:
        raise ValueError(f"{name}: planes {tuple(planes.shape)} exceed the "
                         f"kernel's 32-bit offsets")


def _require_cuda(planes: torch.Tensor, name: str) -> None:
    if planes.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {planes.device}")


def coarse_scores(planes: torch.Tensor, table) -> torch.Tensor:
    """(N, Hd, Wd) int32 whole-image raw scores at the coarse level
    (``similarity``, linemod.cpp:1130-1214, zero-padded beyond the image).

    ``planes``: (C, Hd, Wd) u8 decimated responses (values 0..4; the
    kernel is exact for any u8).  Table offsets ``rx``/``ry`` are
    non-negative, as :func:`detector.build_match_tables` makes them.  CUDA
    tensors run kernel K1; CPU tensors run :func:`coarse_scores_plain`.
    """
    if planes.device.type == "cpu":
        return coarse_scores_plain(planes, table)
    _require_cuda(planes, "coarse_scores")
    dev = planes.device
    _build.require(planes, "planes", torch.uint8, 3, dev)
    n, nf = table["c"].shape
    _require_table(table, n, dev)
    ch, hd, wd = planes.shape
    _require_32bit(planes, "coarse_scores")
    if table["bstart"].shape[1] - 1 > _MAX_OFFSET:
        # K1 packs a feature's offsets as ry << 16 | 8 * rx (rx, ry < NB)
        raise ValueError(f"{table['bstart'].shape[1] - 1} offset buckets "
                         f"exceed {_MAX_OFFSET}")
    out = torch.empty((n, hd, wd), dtype=torch.int32, device=dev)
    if n == 0 or hd * wd == 0:
        return out.zero_()
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.fl_coarse_scores(
            planes.data_ptr(), ch, hd, wd, table["c"].data_ptr(),
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
    origins (negative only for degenerate clamps); table offsets
    ``rx``/``ry`` are non-negative.  CUDA tensors run kernel K2 with the
    origins given; CPU tensors run :func:`local_scores_plain`.
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
    ch, hd, wd = planes.shape
    _require_32bit(planes, "local_scores")
    w16 = LOCAL_WINDOW
    out = torch.empty((k, w16, w16), dtype=torch.int32, device=dev)
    if k == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.fl_local_scores(
            planes.data_ptr(), ch, hd, wd, table_k["c"].data_ptr(),
            table_k["ry"].data_ptr(), table_k["rx"].data_ptr(),
            table_k["bstart"].data_ptr(), k, nf, table_k["bstart"].shape[1],
            px0.data_ptr(), py0.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "local_scores")
    local_scores.launches += 1
    return out


local_scores.launches = 0


def local_refine(planes: torch.Tensor, table, tslot: torch.Tensor,
                 x: torch.Tensor, y: torch.Tensor, width: torch.Tensor,
                 height: torch.Tensor, nfeat: torch.Tensor, level: int,
                 t: int, offset: int, size):
    """One refinement level of the detector for K candidates
    (linemod.cpp:1509-1566): returns the (K, 16, 16) int32 window scores,
    the new int32 x and y, the best raw sum (int32) and
    ``nfeat[tslot, level]``.

    ``planes``: the level's (C, Hd, Wd) u8 responses; ``table``: the
    level's table of :func:`detector.build_match_tables` ((N, F) rows,
    non-negative offsets); ``tslot`` (K,) int64 slots in [0, N);
    ``x``/``y`` (K,) int32 positions at level ``level + 1``;
    ``width``/``height``/``nfeat`` the bank's (N, L) int32 arrays; ``t``
    the level's cell size, ``offset`` its reported-position offset and
    ``size`` its image (h, w).  CUDA tensors run kernel K2 in one launch
    (the table rows are read in place); CPU tensors run
    :func:`local_refine_plain`.
    """
    if planes.device.type == "cpu":
        return local_refine_plain(planes, table, tslot, x, y, width, height,
                                  nfeat, level, t, offset, size)
    _require_cuda(planes, "local_refine")
    dev = planes.device
    _build.require(planes, "planes", torch.uint8, 3, dev)
    _require_32bit(planes, "local_refine")
    n, nf = table["c"].shape
    _require_table(table, n, dev)
    _build.require(tslot, "tslot", torch.int64, 1, dev)
    k = tslot.shape[0]
    for name, v in (("x", x), ("y", y)):
        _build.require(v, name, torch.int32, 1, dev)
        if v.shape[0] != k:
            raise ValueError(f"{name} has {v.shape[0]} entries, expected {k}")
    for name, v in (("width", width), ("height", height), ("nfeat", nfeat)):
        _build.require(v, name, torch.int32, 2, dev)
        if v.shape[0] != n or not 0 <= level < v.shape[1]:
            raise ValueError(f"{name} {tuple(v.shape)} does not cover {n} "
                             f"slots at level {level}")
    ch, hd, wd = planes.shape
    h, w = size
    scores = torch.empty((k, LOCAL_WINDOW, LOCAL_WINDOW), dtype=torch.int32,
                         device=dev)
    x_out, y_out, best, nf_out = torch.empty((4, k), dtype=torch.int32,
                                             device=dev)
    if k == 0:
        return scores, x_out, y_out, best, nf_out
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.fl_local_refine(
            planes.data_ptr(), ch, hd, wd, table["c"].data_ptr(),
            table["ry"].data_ptr(), table["rx"].data_ptr(),
            table["bstart"].data_ptr(), nf, table["bstart"].shape[1],
            tslot.data_ptr(), x.data_ptr(), y.data_ptr(), k,
            width.data_ptr(), height.data_ptr(), nfeat.data_ptr(),
            width.shape[1], level, t, w, h, offset, scores.data_ptr(),
            x_out.data_ptr(), y_out.data_ptr(), best.data_ptr(),
            nf_out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "local_refine")
    local_refine.launches += 1
    return scores, x_out, y_out, best, nf_out


local_refine.launches = 0
