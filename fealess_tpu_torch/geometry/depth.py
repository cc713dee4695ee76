"""Camera intrinsics and point-image normals (counterpart of
``fealess_tpu.geometry.depth``)."""

from __future__ import annotations

import torch


def intrinsics_matrix(fx: float, fy: float, cx: float, cy: float,
                      device="cpu") -> torch.Tensor:
    """3x3 K (setCamIntrinsic, ICP/common.cpp:374-379)."""
    return torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]],
                        dtype=torch.float32, device=device)


def scale_intrinsics(fx: float, fy: float, cx: float, cy: float,
                     zoom: float):
    """Intrinsics after resizing to the processing width
    (PrepareInputData, CadReco/obj_reco_lmicp.cpp:241-248)."""
    return fx * zoom, fy * zoom, cx * zoom, cy * zoom


def normals_from_point_image(points: torch.Tensor) -> torch.Tensor:
    """Per-pixel unit normals of an (H, W, 3) point image: central
    differences along u and v (one-sided at the borders), n = du x dv,
    oriented to face the camera (n . p <= 0).  Pixels whose neighbourhood
    holds an invalid (NaN) point get a zero normal."""
    p = points
    du = torch.cat([p[:, 1:2] - p[:, 0:1], (p[:, 2:] - p[:, :-2]) * 0.5,
                    p[:, -1:] - p[:, -2:-1]], dim=1)
    dv = torch.cat([p[1:2] - p[0:1], (p[2:] - p[:-2]) * 0.5,
                    p[-1:] - p[-2:-1]], dim=0)
    n = torch.linalg.cross(du, dv, dim=-1)
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    ok = torch.isfinite(norm[..., 0]) & (norm[..., 0] > 1e-12)
    n = torch.where(ok[..., None],
                    n / torch.where(ok[..., None], norm, 1.0), 0.0)
    flip = (n * p).sum(dim=-1) > 0
    return torch.where(flip[..., None], -n, n)
