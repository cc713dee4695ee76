"""Rigid-body helpers (counterpart of ``fealess_tpu.geometry.transforms``):
``transformPoints`` (ICP/ICP.cpp:28-45), the SVD alignment step
(ICP/ICP.cpp:726-744), pose composition (ICP/ICP.cpp:793-797) and the ADD
metrics.

Points are ``(..., N, 3)`` float32, rotations ``(3, 3)``, translations
``(3,)``; everything stays on the tensors' device.
"""

from __future__ import annotations

import torch


def transform_points(points: torch.Tensor, r: torch.Tensor,
                     t: torch.Tensor) -> torch.Tensor:
    """Apply ``p -> R p + t`` to an ``(..., N, 3)`` point array."""
    return points @ r.T + t


def compose_rt(r_outer: torch.Tensor, t_outer: torch.Tensor,
               r_inner: torch.Tensor, t_inner: torch.Tensor):
    """outer . inner: the reference's incremental update ``T <- R* T + T*;
    R <- R* R`` (ICP/ICP.cpp:793-797) with outer = (R*, T*)."""
    return r_outer @ r_inner, r_outer @ t_inner + t_outer


def masked_mean(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of ``points`` (N, 3) over rows where ``mask`` is True
    (``getMean``, ICP/ICP.cpp:8-25); zeros for an empty mask."""
    w = mask.to(points.dtype)[..., None]
    count = w.sum(dim=-2).clamp(min=1.0)
    return (points * w).sum(dim=-2) / count[..., 0]


def svd_align(cov: torch.Tensor, m_centroid: torch.Tensor,
              r_centroid: torch.Tensor):
    """The alignment step from a covariance (ICP.cpp:736-744): SVD, R* = V
    U^T, T* = r_centroid - R* m_centroid; and whether both are finite."""
    u, _, vt = torch.linalg.svd(cov)
    r_opt = vt.T @ u.T
    t_opt = r_centroid - r_opt @ m_centroid
    finite = torch.isfinite(r_opt).all() & torch.isfinite(t_opt).all()
    return r_opt, t_opt, finite


def kabsch(model: torch.Tensor, ref: torch.Tensor, mask: torch.Tensor):
    """One point-to-point alignment step, R*, T* minimizing ||R m + T - r||
    over the (N,) ``mask``'s pairs, with the reference's non-centred
    covariance ``sum_i m_i r_i^T`` (ICP/ICP.cpp:726-744; kept for parity).
    Returns (R*, T*, ok); not ok (a non-finite covariance or SVD) gives
    the identity.  A non-finite covariance goes to the SVD as zeros (torch
    refuses it, JAX returns NaN), with no host check."""
    m_centroid = masked_mean(model, mask)
    r_centroid = masked_mean(ref, mask)
    w = mask.to(model.dtype)[:, None]
    cov = (model * w).T @ (ref * w)
    finite = torch.isfinite(cov).all()
    r_opt, t_opt, ok = svd_align(torch.where(finite, cov, 0.0), m_centroid,
                                 r_centroid)
    ok = ok & finite
    eye = torch.eye(3, dtype=model.dtype, device=model.device)
    return (torch.where(ok, r_opt, eye), torch.where(ok, t_opt, 0.0), ok)


def skew(v: torch.Tensor) -> torch.Tensor:
    """Cross-product matrix [v]x of a 3-vector."""
    z = torch.zeros((), dtype=v.dtype, device=v.device)
    return torch.stack([torch.stack([z, -v[2], v[1]]),
                        torch.stack([v[2], z, -v[0]]),
                        torch.stack([-v[1], v[0], z])])


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues exponential map, axis-angle 3-vector -> rotation, with
    series fallbacks below 1e-6 rad (no host branch)."""
    theta2 = (omega * omega).sum()
    theta = torch.sqrt(theta2)
    k = skew(omega)
    small = theta < 1e-6
    one = torch.ones_like(theta)
    a = torch.where(small, 1.0 - theta2 / 6.0,
                    torch.sin(theta) / torch.where(small, one, theta))
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.where(small, one, theta2))
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    return eye + a * k + b * (k @ k)


def pose_matrix_4x4(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Pack ``R, t`` into a 4x4 row-major world2cam matrix
    (CadReco/obj_reco_lmicp.cpp:20-30)."""
    out = torch.zeros((4, 4), dtype=r.dtype, device=r.device)
    out[:3, :3] = r
    out[:3, 3] = t
    out[3, 3] = 1.0
    return out


def pose_from_13floats(pose_info: torch.Tensor):
    """Split the 13-float template pose record into (R, t, view_distance):
    a row-major 3x4 world2cam matrix then the view distance
    (test/linemod_train.cpp:52-57)."""
    rows = pose_info[:12].reshape(3, 4)
    return rows[:, :3], rows[:, 3], pose_info[12]


def rotation_geodesic_deg(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """Geodesic angle between two rotations, in degrees (from the trace of
    ``r1^T r2``, as the JAX package measures it)."""
    cos = (torch.trace(r1.T @ r2) - 1.0) * 0.5
    return torch.rad2deg(torch.arccos(cos.clamp(-1.0, 1.0)))


def add_metric(r1, t1, r2, t2, model_points: torch.Tensor) -> torch.Tensor:
    """Average Distance of model points between two poses (ADD metric)."""
    p1 = transform_points(model_points, r1, t1)
    p2 = transform_points(model_points, r2, t2)
    return torch.linalg.vector_norm(p1 - p2, dim=-1).mean()
