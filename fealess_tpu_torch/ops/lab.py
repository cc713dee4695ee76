"""Kernel-lab variants of the score and nearest-neighbour kernels (L1-L4):
the counterparts of the four Pallas calls of ``benchmarks/kernel_lab.py``.

The lab weighs kernel designs against the served kernels in one process:

- L1 :func:`coarse_variant` (``coarse_run``): K1's coarse sum with the
  features walked bucket by bucket (bucket ``b`` holds the features whose
  column offset ``rx`` is ``b``); modes ``base``, ``skipempty`` (empty
  buckets skipped), ``unroll2`` (two features an iteration; even bucket
  starts), and the diagnostics ``halftrip`` (the first half of each
  bucket) and ``noshift`` (no byte alignment, no mask: wrong by design);
- L2 :func:`coarse_stride2` (``coarse_run_stride2``): K1's sum with
  buckets two columns wide; odd-``rx`` features read a copy of the planes
  shifted one column (:func:`shifted_copy`), so one alignment serves both;
- L3 :func:`local_variant` (``_local_variant_run``): K2's 16x16 window sum
  at given origins, bucket by bucket with ``stride`` 1 or 2 (an odd-``rx``
  feature of a stride-2 bucket read one column on, straight from the
  planes) and ``use_cond`` (skip empty buckets);
- L4 :func:`nn_mxu` (``nn_mxu``): the nearest neighbour in matrix form,
  ``d2 = (|q|^2 + |r|^2) - 2 q.r`` as one TF32 product on the tensor cores
  (``wgmma``): the norms and the -2 ride in 16-slot operands
  (:func:`nn_operands`), so the product's accumulator is d2.

Beside them, the plain-torch functions of the lab's runs that add no
kernel: :func:`build_level_2d_dtype` and :func:`build_level_2d_slices`
(``frontend`` and ``local3``: the served front end's other working type
and decimation) and :func:`gather_rows` (``local``: the candidates' table
rows gathered before K2).

Each wrapper launches its CUDA kernel (``csrc/lab.cu``) for CUDA tensors,
counts the launch in ``.launches``, and runs its plain twin only for CPU
tensors; any other device raises.  Nothing on a serving path imports this
module: ``apps/kernel_lab.py`` drives it.

Bucketed walks read a feature of bucket ``j`` at column offset
``stride * j + rx % stride``; on a bucketed table (every feature of
``[bstart[b], bstart[b + 1])`` has ``rx == b``, as
``detector.build_match_tables`` and :func:`fixture_like` make them) that
is its own ``rx``, so the exact modes equal K1 and K2.  The twins say it
through :func:`walked_table`: the features a walk reads, as a table for
K1's and K2's twins (``score.coarse_scores_plain``,
``score.local_scores_plain``).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from fealess_tpu_torch.ops import _build, response, score

MODES = ("base", "noshift", "halftrip", "skipempty", "unroll2")  # L1, in
# the order of csrc/lab.cu's modes
EXACT_MODES = ("base", "skipempty", "unroll2")
RUN = 8               # adjacent x positions an L1/L2 thread owns (kRun)
MAX_TQ = 256          # queries an L4 block holds at most (4 warpgroups)
NN_SLOTS = 16         # L4's TF32 operand slots a point: two k8 steps
NN_TILE = 128         # reference rows a tile of L4's walk (wgmma's n128)
PLAIN_BLOCK = 1024    # queries a step of L4's twin takes
NEAR_TIE_REL = 1e-3   # the lab's near-tie rule: d2 gap / max(d2, 1)
D2_CANCEL = 1e-5      # L4's d2 limit, a share of |q|^2 + |r|^2 (near_tie)
_SMEM_LIMIT = 48 * 1024   # dynamic shared memory without an opt-in
# float32 bit patterns at the edges of TF32 rounding (:func:`tf32_round`):
# exact, halfway (ties away from zero), a bit under and over halfway, both
# signs, +-0, just under a power of two (rounding up carries into the
# exponent), a subnormal halfway, the TPU lab's padding value 3e9, -100,
# and past the largest finite TF32 value (rounds to infinity); infinity and
# NaN stay as they are.
TF32_EDGE_BITS = (0x3F800000, 0x3F801000, 0x3F800FFF, 0x3F801001,
                  0x3F803000, 0xBF801000, 0xBF800FFF, 0xBF803000,
                  0x00000000, 0x80000000, 0x3F7FF000, 0x3F7FEFFF,
                  0xBF7FF000, 0x00001000, 0x4F32D05E, 0xC2C80000,
                  0x7F7FFFFF, 0x7F800000, 0x7FC00000)


def fixture_like(seed=0, n=1024, f=126, nb=13, hd=30, wd=40, c=1024,
                 even=False, valid_frac=1.0, device="cuda"):
    """The lab's inputs (``kernel_lab._fixture_like``, the same arrays for
    the same arguments): (C, Hd, Wd) u8 planes in 0..4 and a bucket-sorted
    table of N templates x F features (valid features first, grouped by
    ``rx``; ``bstart`` (N, NB+1) their bucket starts), int32, on
    ``device``."""
    rng = np.random.default_rng(seed)
    planes = rng.integers(0, 5, (c, hd, wd), np.uint8)
    nf = int(f * valid_frac)
    if even:
        counts = 2 * rng.integers(0, max(nf // (2 * nb), 1) + 1, (n, nb))
    else:
        counts = rng.integers(0, max(nf // nb, 1) + 1, (n, nb))
    counts = np.minimum(counts, f // nb)
    rx = np.zeros((n, f), np.int64)
    for i in range(n):
        vals = np.repeat(np.arange(nb), counts[i])[:f]
        rx[i, :len(vals)] = vals
    ry = rng.integers(0, nb, (n, f))
    cc = rng.integers(0, c, (n, f))
    bstart = np.concatenate([np.zeros((n, 1), np.int64),
                             np.cumsum(counts, axis=1)], axis=1)
    bstart = np.minimum(bstart, f)
    table = {k: torch.from_numpy(v.astype(np.int32)).to(device)
             for k, v in (("c", cc), ("ry", ry), ("rx", rx),
                          ("bstart", bstart))}
    return torch.from_numpy(planes).to(device), table


def crowded_table(seed=11, n=8, per_bucket=300, nb=13, f=4096, c=1024,
                  device="cuda"):
    """A bucketed table of N templates x F slots with ``per_bucket`` live
    features in every one of its ``nb`` buckets (rx the bucket, ry 0, c
    drawn in [0, C) from ``seed``): on planes all 255 a walk that flushed
    its packed 16-bit lanes only at bucket ends would overflow them (300
    adds of 255 > 65535), so only a flush every 256 features of the whole
    walk keeps the sums exact."""
    if per_bucket * nb > f:
        raise ValueError(f"{per_bucket} x {nb} features exceed {f} slots")
    rng = np.random.default_rng(seed)
    rx = np.zeros((n, f), np.int64)
    rx[:, :per_bucket * nb] = np.repeat(np.arange(nb), per_bucket)
    arrays = (("c", rng.integers(0, c, (n, f))), ("ry", np.zeros((n, f))),
              ("rx", rx),
              ("bstart", np.tile(per_bucket * np.arange(nb + 1), (n, 1))))
    return {k: torch.from_numpy(v.astype(np.int32)).to(device)
            for k, v in arrays}


def bucket_starts(bstart: torch.Tensor, stride: int) -> torch.Tensor:
    """Stride-1 bucket starts -> stride-``stride`` ones (bucket j spans rx
    in [stride*j, stride*(j+1)): rows bstart[stride*j] to
    bstart[min(stride*(j+1), NB)]), as ``score_pallas._bucket_starts``."""
    if stride == 1:
        return bstart
    nb = bstart.shape[1] - 1
    out = bstart[:, ::stride]
    if nb % stride:
        out = torch.cat([out, bstart[:, -1:]], dim=1)
    return out.contiguous()


def stride2_bucket_starts(table) -> torch.Tensor:
    """The lab's re-bucketing for L2 (``coarse_run_stride2``): valid
    features keyed by ``rx // 2`` and counted per key, (N, ceil(NB/2)+1)
    int32 starts.  On an rx-sorted table it equals
    ``bucket_starts(bstart, 2)``."""
    bstart, rx = table["bstart"], table["rx"]
    n, nf = rx.shape
    nb2 = -(-(bstart.shape[1] - 1) // 2)
    fid = torch.arange(nf, device=rx.device)[None, :]
    key = torch.where(fid < bstart[:, -1:], rx // 2, nb2)
    counts = (key[:, None, :] == torch.arange(
        nb2, device=rx.device)[None, :, None]).sum(dim=2)
    return torch.cat([torch.zeros((n, 1), dtype=torch.int32,
                                  device=rx.device),
                      counts.cumsum(dim=1).to(torch.int32)], dim=1)


def shifted_copy(planes: torch.Tensor, out=None) -> torch.Tensor:
    """``out[..., x] = planes[..., x + 1]``, 0 at column Wd - 1 (written
    into ``out`` when given)."""
    if out is None:
        out = torch.empty_like(planes)
    out[..., :-1] = planes[..., 1:]
    out[..., -1] = 0
    return out


def plane_stack(planes: torch.Tensor) -> torch.Tensor:
    """(2, C, Hd, Wd) u8 scratch: the planes and their :func:`shifted_copy`,
    one buffer, so that an odd-``rx`` feature's offset moves by one stack
    (``kernel_lab``'s ``d2``: the packed planes and their shifted copy)."""
    stack = torch.empty((2,) + tuple(planes.shape), dtype=planes.dtype,
                        device=planes.device)
    stack[0] = planes
    shifted_copy(planes, out=stack[1])
    return stack


def walked_table(table, bstart: torch.Tensor, stride: int = 1,
                 half: bool = False):
    """The features a bucketed walk reads, as a table for K1's and K2's
    twins: bucket j of ``bstart`` (its rows ``[bstart[j], bstart[j+1])``,
    or with ``half`` the first ``(hi - lo) // 2`` of them) read at column
    offset ``stride * j + rx % stride``; compacted valid-first, ``bstart``
    zero but for its last column, the count (the table's own width, so
    the twins pad as for the table)."""
    c, ry, rx = table["c"], table["ry"], table["rx"]
    n, nf = c.shape
    dev = c.device
    nbk = bstart.shape[1] - 1
    fid = torch.arange(nf, dtype=bstart.dtype,
                       device=dev)[None, :].expand(n, nf).contiguous()
    # bucket of each feature: the buckets whose end is at or below it
    j = torch.searchsorted(bstart[:, 1:].contiguous(), fid, right=True)
    jc = j.clamp(max=max(nbk - 1, 0))
    lo = bstart.gather(1, jc)
    hi = bstart.gather(1, jc + 1) if nbk else lo
    if half:
        hi = lo + (hi - lo) // 2
    keep = (j < nbk) & (fid >= lo) & (fid < hi)
    col = stride * jc + rx % stride
    order = torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices
    count = keep.sum(dim=1).to(torch.int32)
    width = table["bstart"].shape[1]
    out_bstart = torch.zeros((n, width), dtype=torch.int32, device=dev)
    out_bstart[:, -1] = count
    return {"c": c.gather(1, order), "ry": ry.gather(1, order),
            "rx": col.to(torch.int32).gather(1, order),
            "bstart": out_bstart}


def _noshift_plain(planes: torch.Tensor, table) -> torch.Tensor:
    """L1 ``noshift``: each thread of the kernel owns RUN adjacent x
    positions from x0 = RUN * (x // RUN) and, per walked feature (channel
    c, row offset ry, bucket b), reads the RUN // 4 aligned 32-bit words
    from the word holding plane byte c*Hd*Wd + (y + ry)*Wd + x0 + b
    (clamped to the planes' last word), unshifted and unmasked: position
    x0 + 4q + i adds byte i of word q.  Defined for planes that start on a
    4-byte boundary and hold a multiple of 4 bytes."""
    ch, hd, wd = planes.shape
    walk = walked_table(table, table["bstart"])
    flat = planes.reshape(-1).to(torch.int32)
    last_word = flat.numel() // 4 - 1
    n, nf = walk["c"].shape
    dev = planes.device
    y = torch.arange(hd, device=dev)[None, :, None]
    x = torch.arange(wd, device=dev)[None, None, :]
    x0 = x - x % RUN
    q = (x % RUN) // 4
    acc = torch.zeros((n, hd, wd), dtype=torch.int32, device=dev)
    nvalid = walk["bstart"][:, -1]
    for f in range(nf):
        cc = walk["c"][:, f, None, None].long()
        start = cc * (hd * wd) + (y + walk["ry"][:, f, None, None]) * wd \
            + x0 + walk["rx"][:, f, None, None]
        word = torch.clamp(start // 4 + q, max=last_word)
        acc += torch.where((f < nvalid)[:, None, None],
                           flat[word * 4 + x % 4], 0)
    return acc


def coarse_variant_plain(planes: torch.Tensor, table,
                         mode: str = "base") -> torch.Tensor:
    """Twin of L1: K1's twin on the features the mode walks (every bucket,
    or the first half of each for ``halftrip``), each at its bucket's
    column; ``noshift`` by its own rule (:func:`_noshift_plain`)."""
    _check_mode(mode, table["bstart"])
    if mode == "noshift":
        return _noshift_plain(planes, table)
    walk = walked_table(table, table["bstart"], half=mode == "halftrip")
    return score.coarse_scores_plain(planes, walk)


def coarse_stride2_plain(planes: torch.Tensor, table,
                         skipempty: bool = True) -> torch.Tensor:
    """Twin of L2: K1's twin on the features of the stride-2 buckets of
    :func:`stride2_bucket_starts`, bucket j's at column 2j + rx % 2
    (``skipempty`` changes no sum)."""
    walk = walked_table(table, stride2_bucket_starts(table), stride=2)
    return score.coarse_scores_plain(planes, walk)


def local_variant_plain(planes: torch.Tensor, table_k, px0: torch.Tensor,
                        py0: torch.Tensor, stride: int = 1,
                        use_cond: bool = True) -> torch.Tensor:
    """Twin of L3: K2's twin on the features of the stride-``stride``
    buckets (:func:`bucket_starts`), bucket j's at column
    stride*j + rx % stride (``use_cond`` changes no sum)."""
    _check_stride(stride)
    walk = walked_table(table_k, bucket_starts(table_k["bstart"], stride),
                        stride=stride)
    return score.local_scores_plain(planes, walk, px0, py0)


@contextlib.contextmanager
def _full_float32():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def nn_mxu_plain(query: torch.Tensor, ref: torch.Tensor):
    """Twin of L4, blocked over queries: d2 = (|q|^2 + |r|^2) - 2.0 *
    (q @ r.T) in float32 (TF32 off: ``allow_tf32`` is set False around the
    product), in ``_nn_mxu_kernel``'s order; (idx (Nq,) int32 of the first
    minimum, d2 (Nq,) f32)."""
    rn = (ref * ref).sum(dim=1)
    idx_out, d2_out = [], []
    with _full_float32():
        for s in range(0, query.shape[0], PLAIN_BLOCK):
            qb = query[s:s + PLAIN_BLOCK]
            d2 = ((qb * qb).sum(dim=1)[:, None] + rn[None, :]) \
                - 2.0 * (qb @ ref.T)
            i = d2.argmin(dim=1)
            idx_out.append(i.to(torch.int32))
            d2_out.append(d2.gather(1, i[:, None])[:, 0])
    if not idx_out:
        return (torch.empty(0, dtype=torch.int32, device=query.device),
                torch.empty(0, dtype=torch.float32, device=query.device))
    return torch.cat(idx_out), torch.cat(d2_out)


def _check_mode(mode: str, bstart: torch.Tensor) -> None:
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    if mode != "unroll2" or (bstart.is_cuda and
                             torch.cuda.is_current_stream_capturing()):
        # the check is a host read, so it is skipped while a CUDA graph
        # captures: capture records calls whose inputs were checked before
        return
    if bool((bstart % 2 != 0).any()):
        raise ValueError("unroll2 takes two features an iteration and "
                         "needs even bucket starts")


def _check_stride(stride: int) -> None:
    if stride not in (1, 2):
        raise ValueError(f"stride {stride} is not 1 or 2")


def _require_device(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device}")


def _require_inputs(planes, table, rows: int, copies: int, name: str,
                    staged_starts: bool = True):
    """Raise unless the planes (u8, 3-D, ``copies`` of them within 32-bit
    offsets) and the table are what the scorers take, and the table fits
    the shared memory a block stages it in: 8 bytes a feature, and the
    bucket starts beside them where ``staged_starts`` (L1, L2; L3 keeps a
    bucket's bounds in its thread's registers)."""
    dev = planes.device
    _build.require(planes, "planes", torch.uint8, 3, dev)
    score._require_table(table, rows, dev)
    if copies * planes.numel() >= 2 ** 31:
        raise ValueError(f"{name}: planes {tuple(planes.shape)} exceed the "
                         f"kernel's 32-bit offsets")
    nf = table["c"].shape[1]
    nb1 = table["bstart"].shape[1] if staged_starts else 0
    if nf * 8 + nb1 * 4 > _SMEM_LIMIT:
        raise ValueError(f"{name}: {nf} features and {nb1} staged bucket "
                         f"starts exceed {_SMEM_LIMIT} bytes of staged "
                         f"table")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def coarse_variant(planes: torch.Tensor, table,
                   mode: str = "base") -> torch.Tensor:
    """L1: (N, Hd, Wd) int32 coarse sums, features walked bucket by bucket
    in ``mode`` (one of :data:`MODES`; ``unroll2`` raises ``ValueError``
    on an odd bucket start).  ``planes``: (C, Hd, Wd) u8, any values;
    ``table``: a bucketed level table with offsets in [0, NB).  CUDA
    tensors run ``fl_lab_coarse``; CPU tensors :func:`coarse_variant_plain`.
    ``noshift`` needs planes on a 4-byte boundary with a multiple of 4
    bytes."""
    _check_mode(mode, table["bstart"])
    if planes.device.type == "cpu":
        return coarse_variant_plain(planes, table, mode)
    _require_device(planes, "coarse_variant")
    n, nf = table["c"].shape
    _require_inputs(planes, table, n, 1, "coarse_variant")
    if mode == "noshift" and (planes.data_ptr() % 4 or planes.numel() % 4):
        raise ValueError("noshift reads whole words: planes must start on a "
                         "4-byte boundary and hold a multiple of 4 bytes")
    ch, hd, wd = planes.shape
    out = torch.empty((n, hd, wd), dtype=torch.int32, device=planes.device)
    if n == 0 or hd * wd == 0:
        return out.zero_()
    lib = _build.library()
    with torch.cuda.device(planes.device):
        rc = lib.fl_lab_coarse(
            planes.data_ptr(), ch, hd, wd, table["c"].data_ptr(),
            table["ry"].data_ptr(), table["bstart"].data_ptr(), n, nf,
            table["bstart"].shape[1], MODES.index(mode), out.data_ptr(),
            _stream(planes.device))
    _build.check(rc, "coarse_variant")
    coarse_variant.launches += 1
    return out


coarse_variant.launches = 0


def stride2_inputs(planes: torch.Tensor, table):
    """L2's prepared inputs: (:func:`plane_stack`, the stride-2 bucket
    starts of :func:`stride2_bucket_starts`)."""
    return plane_stack(planes), stride2_bucket_starts(table)


def coarse_stride2(planes: torch.Tensor, table, skipempty: bool = True,
                   prepared=None) -> torch.Tensor:
    """L2: (N, Hd, Wd) int32 coarse sums with buckets two columns wide;
    the wrapper builds the plane stack and the stride-2 starts
    (:func:`stride2_inputs`) unless ``prepared`` gives them (the kernel
    alone).  Planes and table as for :func:`coarse_variant`.  CUDA tensors
    run ``fl_lab_coarse_stride2``; CPU tensors
    :func:`coarse_stride2_plain`."""
    if planes.device.type == "cpu":
        return coarse_stride2_plain(planes, table, skipempty)
    _require_device(planes, "coarse_stride2")
    n, nf = table["c"].shape
    _require_inputs(planes, table, n, 2, "coarse_stride2")
    stack, starts = prepared if prepared is not None else \
        stride2_inputs(planes, table)
    ch, hd, wd = planes.shape
    _build.require(stack, "stack", torch.uint8, 4, planes.device)
    _build.require(starts, "bucket starts", torch.int32, 2, planes.device)
    if stack.shape != (2, ch, hd, wd) or starts.shape[0] != n:
        raise ValueError(f"prepared {tuple(stack.shape)}, "
                         f"{tuple(starts.shape)} do not fit planes "
                         f"{tuple(planes.shape)} and {n} rows")
    out = torch.empty((n, hd, wd), dtype=torch.int32, device=planes.device)
    if n == 0 or hd * wd == 0:
        return out.zero_()
    lib = _build.library()
    with torch.cuda.device(planes.device):
        rc = lib.fl_lab_coarse_stride2(
            stack.data_ptr(), ch, hd, wd, table["c"].data_ptr(),
            table["ry"].data_ptr(), table["rx"].data_ptr(),
            starts.data_ptr(), n, nf, starts.shape[1], int(skipempty),
            out.data_ptr(), _stream(planes.device))
    _build.check(rc, "coarse_stride2")
    coarse_stride2.launches += 1
    return out


coarse_stride2.launches = 0


def local_variant(planes: torch.Tensor, table_k, px0: torch.Tensor,
                  py0: torch.Tensor, stride: int = 1,
                  use_cond: bool = True) -> torch.Tensor:
    """L3: (K, 16, 16) int32 window sums at the origins (K2's contract:
    origins clamped non-negative, rows outside [0, Hd] dropped, reads past
    the plane 0), features walked bucket by bucket at ``stride`` 1 or 2
    (the stride's buckets of :func:`bucket_starts`, bucket j's features at
    column stride*j + rx % stride), empty buckets skipped with
    ``use_cond`` (the JAX lab's knob: the kernel's walk meets no empty
    bucket, so it takes no such argument and both settings run the same
    launch).  ``table_k``: the candidates' bucketed table rows.  CUDA
    tensors run ``fl_lab_local``, one launch on the planes and the table's
    own starts at either stride (the kernel takes the stride's starts
    itself), ``out`` the only allocation; CPU tensors
    :func:`local_variant_plain`."""
    _check_stride(stride)
    if planes.device.type == "cpu":
        return local_variant_plain(planes, table_k, px0, py0, stride,
                                   use_cond)
    _require_device(planes, "local_variant")
    dev = planes.device
    k, nf = table_k["c"].shape
    _require_inputs(planes, table_k, k, 1, "local_variant",
                    staged_starts=False)
    for name, t in (("px0", px0), ("py0", py0)):
        _build.require(t, name, torch.int32, 1, dev)
        if t.shape[0] != k:
            raise ValueError(f"{name} has {t.shape[0]} entries, expected {k}")
    ch, hd, wd = planes.shape
    w16 = score.LOCAL_WINDOW
    out = torch.empty((k, w16, w16), dtype=torch.int32, device=dev)
    if k == 0 or planes.numel() == 0:
        return out.zero_()
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.fl_lab_local(
            planes.data_ptr(), ch, hd, wd, table_k["c"].data_ptr(),
            table_k["ry"].data_ptr(), table_k["rx"].data_ptr(),
            table_k["bstart"].data_ptr(), k, nf, table_k["bstart"].shape[1],
            stride, px0.data_ptr(), py0.data_ptr(), out.data_ptr(),
            _stream(dev))
    _build.check(rc, "local_variant")
    local_variant.launches += 1
    return out


local_variant.launches = 0


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to
    10 mantissa bits, to nearest with ties away from zero, on the bits
    (magnitude + 2^12, the low 13 bits cleared; a carry into the exponent
    is the next binade, past the largest finite value infinity).  The
    tensor core reads a float32 register as TF32 by dropping those 13 bits,
    so it reads the rounded value as it is.  NaN stays NaN."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    mag = u & 0x7FFFFFFF
    out = torch.where(mag > 0x7F800000, u,
                      (u & 0x80000000) | ((mag + 0x1000) & 0x7FFFE000))
    return (out - ((out >> 31) << 32)).to(torch.int32).view(torch.float32)


def _split(p: torch.Tensor):
    """(hi, lo): hi = tf32(p), lo = tf32(p - hi) (the difference exact)."""
    hi = tf32_round(p)
    return hi, tf32_round(p - hi)


def _norm_pieces(p: torch.Tensor) -> torch.Tensor:
    """(N, 3): the float32 norm (x*x + y*y) + z*z in three TF32 pieces
    that sum to it exactly (each remainder is exact in float32)."""
    v = p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1] + p[:, 2] * p[:, 2]
    n0 = tf32_round(v)
    r = v - n0
    n1 = tf32_round(r)
    return torch.stack([n0, n1, tf32_round(r - n1)], dim=1)


def nn_operands_plain(query: torch.Tensor, ref: torch.Tensor):
    """Twin of L4's operand kernel, in logical order: (A (Nq, 16), B
    (Nr_pad, 16)) float32 holding TF32 values, Nr_pad = Nr rounded up to
    :data:`NN_TILE` (rows past Nr 0).  Two k8 steps (hi/lo of
    :func:`_split`, n0..n2 of :func:`_norm_pieces`)::

        A = [-2q_hi, -2q_lo, qn0, qn1 | -2q_hi, qn2, 1, 1, 1, 0]
        B = [r_hi, r_hi, 1, 1         | r_lo, 1, rn0, rn1, rn2, 0]

    so A @ B.T = (|q|^2 + |r|^2) - 2 (hi.hi + lo.hi + hi.lo): d2 with the
    dot at float32 accuracy; every product is exact in float32."""
    nr = ref.shape[0]
    nr_pad = -(-nr // NN_TILE) * NN_TILE
    qh, ql = _split(query)
    rh, rl = _split(ref)
    qn, rn = _norm_pieces(query), _norm_pieces(ref)

    def const(n, v, k):
        return torch.full((n, k), v, dtype=torch.float32, device=ref.device)

    nq = query.shape[0]
    a = torch.cat([-2 * qh, -2 * ql, qn[:, :2], -2 * qh, qn[:, 2:],
                   const(nq, 1.0, 3), const(nq, 0.0, 1)], dim=1)
    b = torch.zeros((nr_pad, NN_SLOTS), dtype=torch.float32,
                    device=ref.device)
    b[:nr] = torch.cat([rh, rh, const(nr, 1.0, 2), rl, const(nr, 1.0, 1),
                        rn, const(nr, 0.0, 1)], dim=1)
    return a, b


def tile_order(b: torch.Tensor) -> torch.Tensor:
    """Logical (Nr_pad, 16) B -> the kernel's tile order, (Nr_pad / 8, k
    step, k half, row, 4): wgmma's no-swizzle K-major layout, 8-row core
    matrices of 16 bytes a row, so a tile of :data:`NN_TILE` rows is one
    piece of 64 bytes a row."""
    return b.reshape(-1, 8, 2, 2, 4).permute(0, 2, 3, 1, 4).contiguous()


def _require_points(query: torch.Tensor, ref: torch.Tensor, dev) -> None:
    for name, t in (("query", query), ("ref", ref)):
        _build.require(t, name, torch.float32, 2, dev)
        if t.shape[1] != 3:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"(N, 3)")


def nn_operands(query: torch.Tensor, ref: torch.Tensor):
    """L4's operands, written once a call: (A (Nq, 16), B in
    :func:`tile_order`, (Nr_pad / 8, 2, 2, 8, 4)) float32.  CUDA tensors
    run ``fl_lab_nn_operands``; CPU tensors :func:`nn_operands_plain`."""
    if query.device.type == "cpu":
        a, b = nn_operands_plain(query, ref)
        return a, tile_order(b)
    _require_device(query, "nn_operands")
    dev = query.device
    _require_points(query, ref, dev)
    nq, nr = query.shape[0], ref.shape[0]
    nr_pad = -(-nr // NN_TILE) * NN_TILE
    a = torch.empty((nq, NN_SLOTS), dtype=torch.float32, device=dev)
    b = torch.empty((nr_pad // 8, 2, 2, 8, 4), dtype=torch.float32,
                    device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.fl_lab_nn_operands(query.data_ptr(), nq, ref.data_ptr(), nr,
                                    nr_pad, a.data_ptr(), b.data_ptr(),
                                    _stream(dev))
    _build.check(rc, "nn_operands")
    return a, b


def nn_mxu(query: torch.Tensor, ref: torch.Tensor, tq: int = 256,
           tr: int = 2048, prepared=None):
    """L4: index and squared distance of the nearest ``ref`` row per
    ``query`` row, (idx (Nq,) int32, d2 (Nq,) f32), both (N, 3) float32,
    d2 in the matrix form of :func:`nn_mxu_plain`.  A block takes ``tq``
    queries (a multiple of 32, at most :data:`MAX_TQ`; ceil(tq / 64)
    warpgroups of 64) against ``tr`` reference rows (the lab's tiles; the
    kernel walks ``tr`` rounded up to :data:`NN_TILE`), keeping the first
    minimum within them; blocks are merged in reference order with a
    strict "<".  The wrapper writes the operands (:func:`nn_operands`)
    unless ``prepared`` gives them (the kernel alone).  CUDA tensors run
    ``fl_lab_nn_mma`` (one TF32 wgmma product whose accumulator is d2);
    CPU tensors :func:`nn_mxu_plain`.  Near-ties may pick another index
    than K3's."""
    if tq % 32 or not 32 <= tq <= MAX_TQ or tr < 1:
        raise ValueError(f"tiles tq={tq}, tr={tr}: tq must be a multiple of "
                         f"32 in [32, {MAX_TQ}] and tr positive")
    if ref.shape[0] == 0:
        raise ValueError("nn_mxu needs at least one ref row")
    if query.device.type == "cpu":
        return nn_mxu_plain(query, ref)
    _require_device(query, "nn_mxu")
    dev = query.device
    _require_points(query, ref, dev)
    nq, nr = query.shape[0], ref.shape[0]
    idx = torch.empty(nq, dtype=torch.int32, device=dev)
    d2 = torch.empty(nq, dtype=torch.float32, device=dev)
    if nq == 0:
        return idx, d2
    chunk = -(-tr // NN_TILE) * NN_TILE
    nchunks = -(-nr // chunk)
    if nchunks > 65535:
        raise ValueError(f"{nr} reference rows make {nchunks} blocks of "
                         f"{chunk}, more than a grid's 65535")
    a_op, b_op = prepared if prepared is not None else \
        nn_operands(query, ref)
    _build.require(a_op, "A operand", torch.float32, 2, dev)
    _build.require(b_op, "B operand", torch.float32, 5, dev)
    if a_op.shape != (nq, NN_SLOTS) or \
            b_op.shape != (-(-nr // NN_TILE) * NN_TILE // 8, 2, 2, 8, 4):
        raise ValueError(f"prepared {tuple(a_op.shape)}, "
                         f"{tuple(b_op.shape)} do not fit {nq} queries and "
                         f"{nr} reference rows")
    part_idx = part_d2 = None
    if nchunks > 1:
        part_idx = torch.empty((nchunks, nq), dtype=torch.int32, device=dev)
        part_d2 = torch.empty((nchunks, nq), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.fl_lab_nn_mma(
            a_op.data_ptr(), nq, b_op.data_ptr(), nr, tq, chunk, nchunks,
            None if part_idx is None else part_idx.data_ptr(),
            None if part_d2 is None else part_d2.data_ptr(),
            idx.data_ptr(), d2.data_ptr(), _stream(dev))
    _build.check(rc, "nn_mxu")
    nn_mxu.launches += 1
    return idx, d2


nn_mxu.launches = 0

LAUNCHED = (coarse_variant, coarse_stride2, local_variant, nn_mxu)


def near_tie(idx, d2, idx_ref, d2_ref, query, ref):
    """Two nearest-neighbour results for ``query`` against ``ref`` agree
    when, per query, the lab's near-tie rule holds (the index equal, or
    |d2 - d2_ref| <= NEAR_TIE_REL * max(d2_ref, 1)) and, in every row, d2
    is within the rounding of the matrix form: |d2 - d2_ref| <= D2_CANCEL
    * max(|q|^2 + |r|^2, 1), |r|^2 the larger of the two chosen rows' (the sum
    (qn + rn) - 2 dot cancels to d2 from terms of that size, so its error
    scales with them, not with d2).  Returns (every row passes and every
    index is a row of ``ref``, rows with equal index, the largest
    |d2 - d2_ref| / max(d2_ref, 1), the largest |d2 - d2_ref| /
    (D2_CANCEL * max(|q|^2 + |r|^2, 1)), the share of the d2 limit
    used)."""
    nr = ref.shape[0]
    same = idx == idx_ref
    diff = (d2 - d2_ref).abs()
    gap = diff / d2_ref.clamp(min=1.0)
    rn = (ref * ref).sum(dim=1)
    rows = torch.maximum(rn[idx.long().clamp(0, nr - 1)],
                         rn[idx_ref.long().clamp(0, nr - 1)])
    share = diff / (D2_CANCEL * ((query * query).sum(dim=1) + rows)
                     .clamp(min=1.0))
    in_range = bool(((idx >= 0) & (idx < nr)).all())
    ok = in_range and bool((same | (gap <= NEAR_TIE_REL)).all()) and \
        bool((share <= 1.0).all())
    if not gap.numel():
        return ok, 0, 0.0, 0.0
    return ok, int(same.sum()), float(gap.max()), float(share.max())


# -- the lab's plain-torch rows (no kernel of their own) ----------------------


def build_level_2d_dtype(quantized: torch.Tensor, t: int,
                         work_dtype: torch.dtype) -> torch.Tensor:
    """``response.build_level_2d`` with the decimation and the spread in
    ``work_dtype`` (``kernel_lab._build_level_2d_dtype``): the spread byte
    cast to int32 for the rotations, the (8*T*T, H/T, W/T) responses cast
    back to ``work_dtype``."""
    h, w = quantized.shape
    hd, wd = h // t, w // t
    q = quantized.to(work_dtype)
    q_dec = response.decimate_quant(q, t).reshape(t, t, hd, wd)
    sd = response.spread_decimated(q_dec, t).reshape(t * t, hd, wd)
    b = sd.to(torch.int32)
    return response._response_stack_i32(b).to(work_dtype).reshape(
        8 * t * t, hd, wd)


def build_level_2d_slices(quantized: torch.Tensor, t: int) -> torch.Tensor:
    """``response.build_level_2d`` with the decimation as T*T strided slices
    stacked, no 4-D permute (``lab_local3``'s ``build_level_2d_slices``);
    int32 (8*T*T, H/T, W/T)."""
    h, w = quantized.shape
    hd, wd = h // t, w // t
    q = quantized.to(torch.int32)
    sub = torch.stack([q[a::t, b::t] for a in range(t) for b in range(t)])
    b = response.spread_decimated(sub.reshape(t, t, hd, wd), t).reshape(
        t * t, hd, wd)
    return response._response_stack_i32(b).reshape(8 * t * t, hd, wd)


def gather_rows(table, tslot: torch.Tensor):
    """The rows ``tslot`` of each array of ``table`` (``kernel_lab.
    _gather_fancy``), as ``index_select``: the per-candidate table that
    ``score.local_scores`` takes (``score.local_refine`` reads the rows in
    place instead)."""
    return {k: v.index_select(0, tslot) for k, v in table.items()}
