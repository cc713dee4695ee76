"""Brute-force nearest neighbour for ICP (K3) (counterpart of
``fealess_tpu.ops.nn_pallas`` and ``fealess_tpu.icp.nearest_neighbor``).

The wrapper launches the CUDA kernel (``csrc/nn.cu``) for CUDA tensors and
runs the plain PyTorch twin only for CPU tensors.  Both compute
``d2 = dx*dx + dy*dy + dz*dz`` in float32 in that order, without fused
multiply-adds, and return the first minimum, so they agree bitwise.
"""

from __future__ import annotations

import torch

from fealess_tpu_torch.ops import _build


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
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.fl_nearest_neighbor(
            query.data_ptr(), nq, ref.data_ptr(), nr, idx.data_ptr(),
            d2.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "nearest_neighbor")
    nearest_neighbor.launches += 1
    return idx, d2


nearest_neighbor.launches = 0
