"""Point-sharded ICP: all-reduced count, centroid, covariance and
normal-equation sums (counterpart of ``fealess_tpu.parallel.sharded_icp``).

The paired model/reference clouds split over the mesh's ``p`` axis.
Every iteration each process sums its slice of the pairs and one
all-reduce per step combines the sums: the pair statistics, the
correspondence count with both centroids (and the plain covariance), the
centred covariance, the 6x6 ``H``/``g`` with the point-to-point blend,
and once per refine the normal scatter of the plane gate.  The SVD,
eigensolve and 6x6 solve are repeated on every process on identical
sums.  The NN kernel (K3) searches the whole reference set for each
process's query slice.

The loop is ``icp``'s own: this module passes it the slice, the whole
reference and an all-reduce as its ``reduce`` hook.  Every loop decision
(the too-few-pairs abort, the convergence test) is read from reduced
values, so every process takes the same branch and meets the others in
the next collective.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from fealess_tpu_torch import config as cfg
from fealess_tpu_torch import icp as icp_mod
from fealess_tpu_torch.icp import IcpResult
from fealess_tpu_torch.parallel import mesh as mesh_mod


def _sum_over(group):
    """The ``reduce`` hook: an in-place all-reduce (sum) of a fresh
    tensor over ``group``."""
    def reduce(x: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(x, group=group)
        return x
    return reduce


def _my_points(mesh: DeviceMesh, axis: str, *clouds):
    """This process's contiguous slice of each (P, ...) cloud; P must
    divide by the axis size."""
    i, n = mesh_mod.axis_index(mesh, axis)
    p = clouds[0].shape[0]
    if p % n:
        raise ValueError(f"{p} points do not divide into {n} shards on "
                         f"axis {axis!r}")
    size = p // n
    return [c[i * size:(i + 1) * size] for c in clouds]


def icp_sharded(ref: torch.Tensor, model: torch.Tensor,
                pair_mask: torch.Tensor, icp: cfg.IcpConfig,
                mesh: DeviceMesh, axis: str = "p") -> IcpResult:
    """Point-sharded point-to-point ICP.  Every process passes the whole
    index-paired, padded (P, 3) / (P,) clouds and gets the same result;
    P must divide by the ``axis`` size."""
    ref_s, model_s, mask_s = _my_points(mesh, axis, ref, model, pair_mask)
    return icp_mod.icp_point_to_point(
        ref_s, model_s, mask_s, icp, ref_all=ref,
        reduce=_sum_over(mesh.get_group(axis)))


def icp_plane_sharded(ref: torch.Tensor, ref_normals: torch.Tensor,
                      model: torch.Tensor, pair_mask: torch.Tensor,
                      icp: cfg.IcpConfig, mesh: DeviceMesh,
                      axis: str = "p") -> IcpResult:
    """Point-sharded point-to-plane ICP: each process's partial H and g
    (and the Kabsch sums of the degenerate-plane gate), all-reduced, the
    6x6 solve on every process.  Arguments as :func:`icp_sharded`."""
    ref_s, norm_s, model_s, mask_s = _my_points(mesh, axis, ref,
                                                ref_normals, model,
                                                pair_mask)
    return icp_mod.icp_point_to_plane(
        ref_s, norm_s, model_s, mask_s, icp, ref_all=ref,
        normals_all=ref_normals, reduce=_sum_over(mesh.get_group(axis)))
