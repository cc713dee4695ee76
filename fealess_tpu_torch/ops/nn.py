"""Brute-force nearest neighbour for ICP (K3) (counterpart of
``fealess_tpu.ops.nn_pallas`` and ``fealess_tpu.icp.nearest_neighbor``).

The wrapper launches the CUDA kernel (``csrc/nn.cu``) for CUDA tensors and
runs the plain PyTorch twin only for CPU tensors.  Both compute
``d2 = dx*dx + dy*dy + dz*dz`` in float32 in that order, without fused
multiply-adds, and return the first minimum, so they agree bitwise.

The kernel splits the reference set into chunks (:func:`chunk_plan`),
keeps each chunk's first minimum per query and merges the chunks in order
with a strict "<", which is again the first minimum of the whole set.
"""

from __future__ import annotations

import torch

from fealess_tpu_torch.ops import _build

# The kernel's tiles (kQueryTile, kRefTile in csrc/nn.cu); the wrapper
# checks them against the library at first use.
QUERY_TILE = 512      # queries a block
REF_TILE = 512        # reference rows a shared-memory stage
BLOCKS_PER_SM = 4     # blocks the chunk count aims at on every SM


def chunk_plan(nq: int, nr: int, sm_count: int):
    """(chunks, rows a chunk) of the kernel's split of ``nr`` reference
    rows for ``nq`` queries on a card of ``sm_count`` SMs: about
    ``BLOCKS_PER_SM`` blocks an SM, but no more chunks than ``REF_TILE``
    rows go into ``nr``, rounded up, so a chunk holds about
    ``nr / ceil(nr / REF_TILE)`` rows or more (2600 rows: 6 chunks of
    434); at least one chunk, none empty.  16384 x 16384 on 132 SMs gives
    16 chunks of 1024 rows."""
    qtiles = max(1, -(-nq // QUERY_TILE))
    want = max(1, BLOCKS_PER_SM * sm_count // qtiles)
    n = max(1, min(want, -(-nr // REF_TILE)))
    chunk = -(-nr // n)
    return -(-nr // chunk), chunk


def _library():
    """The kernel library, its tiles checked once against this module's."""
    lib = _build.library()
    if _library.checked is not lib:
        got = (lib.fl_nn_query_tile(), lib.fl_nn_ref_tile())
        if got != (QUERY_TILE, REF_TILE):
            raise RuntimeError(f"csrc/nn.cu tiles (queries, rows) {got}, "
                               f"ops/nn.py plans with "
                               f"{(QUERY_TILE, REF_TILE)}")
        _library.checked = lib
    return lib


_library.checked = None


def nearest_neighbor_plain(query: torch.Tensor, ref: torch.Tensor,
                           block: int = 1024):
    """Twin of K3, blocked over queries: (idx (Nq,) int32, d2 (Nq,) f32).
    ``argmin`` returns the first minimum (documented by PyTorch)."""
    idx_out, d2_out = [], []
    for s in range(0, query.shape[0], block):
        qb = query[s:s + block]
        dx = qb[:, None, 0] - ref[None, :, 0]
        dy = qb[:, None, 1] - ref[None, :, 1]
        dz = qb[:, None, 2] - ref[None, :, 2]
        d2 = dx * dx + dy * dy + dz * dz
        i = d2.argmin(dim=1)
        idx_out.append(i.to(torch.int32))
        d2_out.append(d2.gather(1, i[:, None])[:, 0])
    if not idx_out:
        return (torch.empty(0, dtype=torch.int32, device=query.device),
                torch.empty(0, dtype=torch.float32, device=query.device))
    return torch.cat(idx_out), torch.cat(d2_out)


def nearest_neighbor(query: torch.Tensor, ref: torch.Tensor):
    """Index and squared distance of the nearest ``ref`` row per ``query``
    row: (idx (Nq,) int32, d2 (Nq,) f32).  Both are (N, 3) float32; callers
    pad invalid rows to ``icp.PAD_COORD``.  CUDA tensors run kernel K3; CPU
    tensors run :func:`nearest_neighbor_plain`."""
    if ref.shape[0] == 0:
        raise ValueError("nearest_neighbor needs at least one ref row")
    if query.device.type == "cpu":
        return nearest_neighbor_plain(query, ref)
    if query.device.type != "cuda":
        raise ValueError(f"nearest_neighbor: no kernel for device "
                         f"{query.device}")
    dev = query.device
    for name, t in (("query", query), ("ref", ref)):
        _build.require(t, name, torch.float32, 2, dev)
        if t.shape[1] != 3:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"(N, 3)")
    nq, nr = query.shape[0], ref.shape[0]
    idx = torch.empty(nq, dtype=torch.int32, device=dev)
    d2 = torch.empty(nq, dtype=torch.float32, device=dev)
    if nq == 0:
        return idx, d2
    nchunks, chunk = chunk_plan(
        nq, nr, torch.cuda.get_device_properties(dev).multi_processor_count)
    part_idx = part_d2 = None
    if nchunks > 1:
        part_idx = torch.empty((nchunks, nq), dtype=torch.int32, device=dev)
        part_d2 = torch.empty((nchunks, nq), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.fl_nearest_neighbor(
            query.data_ptr(), nq, ref.data_ptr(), nr, chunk, nchunks,
            None if part_idx is None else part_idx.data_ptr(),
            None if part_d2 is None else part_d2.data_ptr(),
            idx.data_ptr(), d2.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "nearest_neighbor")
    nearest_neighbor.launches += 1
    return idx, d2


nearest_neighbor.launches = 0
