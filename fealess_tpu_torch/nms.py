"""3D non-maximum suppression over refined candidates (counterpart of
``fealess_tpu.nms``).

``nonMaximumSuppression`` (ICP/NMS.cpp:6-40) with the JAX version's exact
sequential semantics: for each unchecked seed ``i`` (input order), scan
``j > i``; an unchecked ``j`` within ``th_obj_dist`` of the CURRENT winner
joins the cluster (is marked checked) and becomes the winner if its
model-point count exceeds 85% of the SEED's count and its ``icp_dist`` is
smaller.  One pose is emitted per cluster, taken from the final winner.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class NmsResult:
    keep: torch.Tensor       # (K,) bool: a cluster was seeded at this index
    winner: torch.Tensor     # (K,) int32: the cluster's winning candidate


def nms_3d(t: torch.Tensor, icp_dist: torch.Tensor,
           n_model_points: torch.Tensor, valid: torch.Tensor,
           th_obj_dist: float) -> NmsResult:
    """Args are (K,)-shaped candidate fields (``t`` is (K, 3) mm) on any
    device; the result is on the host.

    The pairwise ``near`` matrix is built where ``t`` lives, in float32 as
    the JAX version does (``norm < th``).  The scan itself is K*K
    dependent scalar steps (the winner moves as the cluster grows), with
    K = ``max_objects``, a handful: as device work that would be hundreds
    of one-element launches, each read back to decide the next.  So
    ``near`` and the small fields come to the host in ONE transfer and the
    scan runs there."""
    k = t.shape[0]
    diff = t[:, None, :] - t[None, :, :]
    near = torch.sqrt((diff * diff).sum(dim=-1)) < th_obj_dist
    host = torch.cat([near.reshape(-1).double(), icp_dist.double(),
                      n_model_points.double(), valid.double()]).cpu().numpy()
    near = host[:k * k].reshape(k, k) > 0
    dist = host[k * k:k * k + k]                # float32 values, exact
    npts = host[k * k + k:k * k + 2 * k].astype(np.float32)
    ok = host[k * k + 2 * k:] > 0

    checked = np.zeros(k, bool)
    keep = np.zeros(k, bool)
    winner = np.full(k, -1, np.int32)
    for i in range(k):
        if not ok[i] or checked[i]:
            continue
        # floor(0.85 * f32(n_seed)) in float32, as the JAX version
        size_th = np.floor(np.float32(0.85) * npts[i])
        best = i
        for j in range(i + 1, k):
            if ok[j] and not checked[j] and near[best, j]:
                checked[j] = True
                if npts[j] > size_th and dist[j] < dist[best]:
                    best = j
        checked[i] = True
        keep[i] = True
        winner[i] = best
    return NmsResult(keep=torch.from_numpy(keep),
                     winner=torch.from_numpy(winner))
