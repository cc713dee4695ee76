"""Rigid-body helpers (counterpart of ``fealess_tpu.geometry.transforms``).

Points are ``(N, 3)`` float32, rotations ``(3, 3)``, translations ``(3,)``;
everything stays on the tensors' device.
"""

from __future__ import annotations

import torch


def masked_mean(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of ``points`` (N, 3) over rows where ``mask`` is True
    (``getMean``, ICP/ICP.cpp:8-25); zeros for an empty mask."""
    w = mask.to(points.dtype)[..., None]
    count = w.sum(dim=-2).clamp(min=1.0)
    return (points * w).sum(dim=-2) / count[..., 0]


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
