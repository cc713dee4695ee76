"""Camera intrinsics, depth back-projection and point-image normals
(counterpart of ``fealess_tpu.geometry.depth``)."""

from __future__ import annotations

import torch


def intrinsics_matrix(fx: float, fy: float, cx: float, cy: float,
                      device="cuda") -> torch.Tensor:
    """3x3 K (setCamIntrinsic, ICP/common.cpp:374-379)."""
    return torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]],
                        dtype=torch.float32, device=device)


def scale_intrinsics(fx: float, fy: float, cx: float, cy: float,
                     zoom: float):
    """Intrinsics after resizing to the processing width
    (PrepareInputData, CadReco/obj_reco_lmicp.cpp:241-248)."""
    return fx * zoom, fy * zoom, cx * zoom, cy * zoom


def rescale_depth_to_m(depth_u16: torch.Tensor) -> torch.Tensor:
    """u16 depth (mm) -> float32 metres, 0 -> NaN (rescaleDepth,
    ICP/depth_to_3d.cpp:244-269)."""
    z = depth_u16.to(torch.float32) / 1000.0
    return torch.where(depth_u16 == 0, torch.nan, z)


def depth_to_3d(depth_u16: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Back-project an (H, W) depth image (mm) to (H, W, 3) metres with the
    3x3 pinhole ``k``: ``x = (u - cx) / fx * z``, ``y = (v - cy) / fy * z``
    (depthTo3dNoMask, ICP/depth_to_3d.cpp:99-137); zero depth gives NaN
    points."""
    h, w = depth_u16.shape
    z = rescale_depth_to_m(depth_u16)
    k = k.to(torch.float32)
    u = torch.arange(w, dtype=torch.float32, device=z.device)[None, :]
    v = torch.arange(h, dtype=torch.float32, device=z.device)[:, None]
    x = (u - k[0, 2]) / k[0, 0] * z
    y = (v - k[1, 2]) / k[1, 1] * z
    return torch.stack([x, y, z], dim=-1)


def depth_to_3d_mm(depth_u16: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Back-project to millimetres: :func:`depth_to_3d` then x1000
    (depthTo3d and scale_mat_vec3f, ICP/detection.cpp:38-40)."""
    return depth_to_3d(depth_u16, k) * 1000.0


def valid_mm(points_mm: torch.Tensor,
             max_depth_mm: float = 900.0) -> torch.Tensor:
    """Validity of back-projected points in mm: ``z <= max_depth_mm``; NaN
    z compares False, as ``is_vec3f_valid`` rejects it
    (ICP/common.cpp:260-266)."""
    return points_mm[..., 2] <= max_depth_mm


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
