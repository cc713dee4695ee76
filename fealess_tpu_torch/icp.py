"""ICP with brute-force nearest neighbours (counterpart of
``fealess_tpu.icp``).

Every numeric convention of the JAX version (and of the reference's
``icpCloudToCloud_Ex``, ICP/ICP.cpp:617-809) is kept: identity pairing on
iteration 1, NN pairs gated by ``d2 <= 3*dist_mean`` after, index-paired
mean distance with the ``z <= valid_depth_max_mm`` gate, signed
``dist_diff``, termination ``dist_mean > thr && dist_diff > thr &&
iter < max``, composition ``T <- R* T + T*; R <- R* R``.

The JAX ``while_loop`` becomes a host-checked loop: each iteration reads
its loop condition and its too-few-pairs abort in one transfer, next to
the synchronisation that ``torch.linalg.svd`` makes on CUDA anyway.  So an
ICP that converges at initialisation launches no NN kernel (K3), and
``iterations`` equals the JAX loop's count.
"""

from __future__ import annotations

import dataclasses

import torch

from fealess_tpu import config as cfg
from fealess_tpu_torch.geometry import transforms as tf
from fealess_tpu_torch.ops import nn

PAD_COORD = 1.0e9      # padded rows live here: never a nearest neighbour
_FMAX = torch.finfo(torch.float32).max


@dataclasses.dataclass
class IcpResult:
    r: torch.Tensor              # (3, 3) accumulated rotation
    t: torch.Tensor              # (3,) accumulated translation
    dist_mean: torch.Tensor      # final mean inlier distance (-1 if not ok)
    inlier_ratio: torch.Tensor
    iterations: torch.Tensor     # int32
    ok: torch.Tensor             # False if input had < min_points pairs


def _masked_pair_stats(model, ref, pair_mask, dist_thr, z_max: float = 900.0):
    """getL2distClouds (ICP.cpp:68-111): index-paired distances with
    z <= z_max validity on both sides and an inlier distance gate."""
    valid = pair_mask & (ref[:, 2] <= z_max) & (model[:, 2] <= z_max)
    dist = torch.linalg.vector_norm(model - ref, dim=1)
    inlier = valid & (dist <= dist_thr)
    n_inlier = inlier.sum()
    n_valid = valid.sum()
    dist_mean = torch.where(
        n_valid > 0,
        torch.where(inlier, dist, 0.0).sum() / n_inlier.to(torch.float32),
        _FMAX)
    ratio = torch.where(n_valid > 0,
                        n_inlier.to(torch.float32) / n_valid.to(torch.float32),
                        0.0)
    return dist_mean, ratio


def _nn_pairs(model_tmp, ref, pair_mask, dist_mean, icp: cfg.IcpConfig):
    """NN correspondences gated by 3*dist_mean (compared with the squared
    distance, as the reference's FLANN L2_Simple does, unless
    ``squared_distance_gate`` is off)."""
    idx, d2 = nn.nearest_neighbor(model_tmp, ref)
    gate = 3.0 * dist_mean
    if not icp.squared_distance_gate:
        gate = gate * gate
    return idx, pair_mask & (d2 <= gate)


def _kabsch(model_tmp, cor_ref, cor_mask, m_centroid, centered: bool):
    """Alignment step (ICP.cpp:726-744): covariance (not centred unless
    ``centered``), SVD, R* = V U^T, T* = r_centroid - R* m_centroid."""
    r_centroid = tf.masked_mean(cor_ref, cor_mask)
    w = cor_mask.to(torch.float32)[:, None]
    if centered:
        cov = ((model_tmp - m_centroid) * w).T @ ((cor_ref - r_centroid) * w)
    else:
        cov = (model_tmp * w).T @ (cor_ref * w)
    u, _, vt = torch.linalg.svd(cov)
    r_opt = vt.T @ u.T
    t_opt = r_centroid - r_opt @ m_centroid
    finite = torch.isfinite(r_opt).all() & torch.isfinite(t_opt).all()
    return r_opt, t_opt, finite


def _icp_loop(ref, model, pair_mask, icp: cfg.IcpConfig, align) -> IcpResult:
    """The shared loop.  ``align(first, model_tmp, dist_mean)`` returns
    (R*, T*, enough, finite) for one iteration."""
    dev = ref.device
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    zero3 = torch.zeros(3, dtype=torch.float32, device=dev)
    zmax = icp.valid_depth_max_mm
    dist_mean, ratio = _masked_pair_stats(model, ref, pair_mask, _FMAX, zmax)
    dist_diff = torch.tensor(_FMAX, dtype=torch.float32, device=dev)

    def more():
        return ((dist_mean > icp.dist_mean_threshold)
                & (dist_diff > icp.dist_diff_threshold))

    ok, go = torch.stack([pair_mask.sum() >= icp.min_points,
                          more()]).tolist()
    it = 0 if ok else icp.max_iterations
    r_acc, t_acc, model_tmp = eye, zero3, model
    while go and it < icp.max_iterations:
        it += 1
        r_opt, t_opt, enough, finite = align(it == 1, model_tmp, dist_mean)
        do_update = enough & finite
        r_opt = torch.where(do_update, r_opt, eye)
        t_opt = torch.where(do_update, t_opt, zero3)
        new_model = model_tmp @ r_opt.T + t_opt
        new_dist, new_ratio = _masked_pair_stats(new_model, ref, pair_mask,
                                                 3.0 * dist_mean, zmax)
        model_tmp = torch.where(do_update, new_model, model_tmp)
        dist_diff = torch.where(do_update, dist_mean - new_dist, dist_diff)
        dist_mean = torch.where(do_update, new_dist, dist_mean)
        ratio = torch.where(do_update, new_ratio, ratio)
        t_acc = torch.where(do_update, r_opt @ t_acc + t_opt, t_acc)
        r_acc = torch.where(do_update, r_opt @ r_acc, r_acc)
        enough, go = torch.stack([enough, more()]).tolist()
        if not enough:
            # too few correspondences aborts the loop (ICP.cpp:711-715)
            it = icp.max_iterations
    ok_dev = torch.tensor(ok, device=dev)
    return IcpResult(r=r_acc if ok else eye, t=t_acc if ok else zero3,
                     dist_mean=dist_mean if ok else torch.full_like(
                         dist_mean, -1.0),
                     inlier_ratio=ratio,
                     iterations=torch.tensor(it, dtype=torch.int32,
                                             device=dev), ok=ok_dev)


def icp_point_to_point(ref: torch.Tensor, model: torch.Tensor,
                       pair_mask: torch.Tensor,
                       icp: cfg.IcpConfig) -> IcpResult:
    """ICP on index-paired, padded (P, 3) clouds (the reference's parity
    mode)."""

    def align(first, model_tmp, dist_mean):
        if first:
            cor_ref, cor_mask = ref, pair_mask
        else:
            idx, cor_mask = _nn_pairs(model_tmp, ref, pair_mask, dist_mean,
                                      icp)
            cor_ref = ref.index_select(0, idx)
        enough = cor_mask.sum() >= icp.min_points
        m_centroid = tf.masked_mean(model_tmp, cor_mask)
        r_opt, t_opt, finite = _kabsch(model_tmp, cor_ref, cor_mask,
                                       m_centroid, icp.centered_covariance)
        return r_opt, t_opt, enough, finite

    return _icp_loop(ref, model, pair_mask, icp, align)


def _gauss_newton(model_tmp, cor_ref, cor_n, cor_mask, centroid,
                  icp: cfg.IcpConfig):
    """Point-to-plane 6x6 normal equations about the model centroid, with
    the point-to-point anchor blend and per-diagonal damping (the JAX
    ``gn_update``)."""
    w = cor_mask.to(torch.float32)[:, None]
    resid = (cor_n * (model_tmp - cor_ref)).sum(dim=1)
    jrow = torch.cat([torch.linalg.cross(model_tmp - centroid, cor_n, dim=1),
                      cor_n], dim=1)                              # (P, 6)
    jw = jrow * w
    h = jw.T @ jw
    g = (jw.T @ (resid * cor_mask)[:, None])[:, 0]
    if icp.plane_point_blend > 0.0:
        mc = model_tmp - centroid
        zeros = torch.zeros_like(mc[:, 0])
        skew_neg = torch.stack([
            torch.stack([zeros, mc[:, 2], -mc[:, 1]], dim=1),
            torch.stack([-mc[:, 2], zeros, mc[:, 0]], dim=1),
            torch.stack([mc[:, 1], -mc[:, 0], zeros], dim=1)], dim=1)
        eye3 = torch.eye(3, dtype=torch.float32,
                         device=mc.device).expand_as(skew_neg)
        j3w = (torch.cat([skew_neg, eye3], dim=2) * w[:, :, None]
               ).reshape(-1, 6)                                   # (3P, 6)
        r3 = ((model_tmp - cor_ref) * w).reshape(-1, 1)
        lam = icp.plane_point_blend
        h = h + lam * (j3w.T @ j3w)
        g = g + lam * (j3w.T @ r3)[:, 0]
    damp = icp.plane_damping * torch.diag(torch.diagonal(h).clamp(min=1.0))
    # solve_ex: no error check, so no host sync (a singular system gives
    # non-finite values, which the caller's ``finite`` gate rejects)
    delta = torch.linalg.solve_ex(h + damp, -g)[0]
    omega, u = delta[:3], delta[3:]
    r_o = tf.so3_exp(omega)
    return r_o, u + centroid - r_o @ centroid, torch.isfinite(delta).all()


def icp_point_to_plane(ref: torch.Tensor, ref_normals: torch.Tensor,
                       model: torch.Tensor, pair_mask: torch.Tensor,
                       icp: cfg.IcpConfig) -> IcpResult:
    """Point-to-plane ICP via 6x6 Gauss-Newton normal equations, with the
    JAX version's degeneracy gate: when the valid normals' scatter is
    near-planar (lambda1 <= plane_min_normal_anisotropy * lambda2) every
    step takes the Kabsch update instead.  The gate is read on the host
    once per refine, so only the selected update runs."""
    normal_ok_ref = (ref_normals * ref_normals).sum(dim=1) > 0.25
    nmask = (pair_mask & normal_ok_ref
             & (ref[:, 2] <= icp.valid_depth_max_mm))
    nw = nmask.to(torch.float32)[:, None]
    scatter = ((ref_normals * nw).T @ (ref_normals * nw)
               / nw.sum().clamp(min=1.0))
    evals = torch.linalg.eigvalsh(scatter)            # ascending
    plane_ok = bool(evals[1] > icp.plane_min_normal_anisotropy * evals[2])

    def align(first, model_tmp, dist_mean):
        if first:
            cor_ref, cor_n = ref, ref_normals
            cor_mask = pair_mask & normal_ok_ref
        else:
            idx, keep = _nn_pairs(model_tmp, ref, pair_mask, dist_mean, icp)
            cor_mask = keep & normal_ok_ref.index_select(0, idx)
            cor_ref = ref.index_select(0, idx)
            cor_n = ref_normals.index_select(0, idx)
        enough = cor_mask.sum() >= icp.min_points
        centroid = tf.masked_mean(model_tmp, cor_mask)
        if plane_ok:
            r_opt, t_opt, finite = _gauss_newton(model_tmp, cor_ref, cor_n,
                                                 cor_mask, centroid, icp)
        else:
            r_opt, t_opt, finite = _kabsch(model_tmp, cor_ref, cor_mask,
                                           centroid, icp.centered_covariance)
        return r_opt, t_opt, enough, finite

    return _icp_loop(ref, model, pair_mask, icp, align)


def icp_refine(ref, model, pair_mask, icp: cfg.IcpConfig,
               ref_normals=None) -> IcpResult:
    """Mode dispatcher: ``icp.mode`` selects point-to-point (reference
    parity) or point-to-plane (requires ``ref_normals``)."""
    if icp.mode == "point_to_plane":
        if ref_normals is None:
            raise ValueError("point_to_plane mode needs ref_normals")
        return icp_point_to_plane(ref, ref_normals, model, pair_mask, icp)
    return icp_point_to_point(ref, model, pair_mask, icp)
