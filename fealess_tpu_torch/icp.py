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

Every sum over the points goes through a ``reduce`` hook, the identity
here; ``parallel.sharded_icp`` passes an all-reduce, so each rank holds a
slice of the pairs and every loop decision is read from reduced values.
"""

from __future__ import annotations

import dataclasses

import torch

from fealess_tpu_torch import config as cfg
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


def _local(x: torch.Tensor) -> torch.Tensor:
    """The ``reduce`` hook of a single device: it holds every point."""
    return x


def _masked_pair_stats(model, ref, pair_mask, dist_thr, z_max: float = 900.0,
                       reduce=_local):
    """getL2distClouds (ICP.cpp:68-111): index-paired distances with
    z <= z_max validity on both sides and an inlier distance gate.  The
    inlier count, the valid count and the distance sum are reduced as one
    tensor."""
    valid = pair_mask & (ref[:, 2] <= z_max) & (model[:, 2] <= z_max)
    dist = torch.linalg.vector_norm(model - ref, dim=1)
    inlier = valid & (dist <= dist_thr)
    n_inlier, n_valid, dist_sum = reduce(torch.stack([
        inlier.sum().to(torch.float32), valid.sum().to(torch.float32),
        torch.where(inlier, dist, 0.0).sum()]))
    dist_mean = torch.where(n_valid > 0, dist_sum / n_inlier, _FMAX)
    ratio = torch.where(n_valid > 0, n_inlier / n_valid, 0.0)
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


def _moments(model_tmp, cor_ref, cor_mask, kabsch: bool, centered: bool,
             reduce):
    """The correspondences' count, both clouds' masked centroids
    (``getMean``, ICP.cpp:8-25) and, for the Kabsch step, the covariance
    (ICP.cpp:726-735; centred only if ``centered``), each summed by
    ``reduce``: count, sums and the plain covariance as one tensor; the
    centred covariance, which needs the centroids, as a second."""
    w = cor_mask.to(torch.float32)[:, None]
    plain = kabsch and not centered
    parts = [w.sum(dim=0), (model_tmp * w).sum(dim=0),
             (cor_ref * w).sum(dim=0)]
    if plain:
        parts.append(((model_tmp * w).T @ (cor_ref * w)).reshape(9))
    sums = reduce(torch.cat(parts))
    count = sums[0]
    m_centroid = sums[1:4] / count.clamp(min=1.0)
    r_centroid = sums[4:7] / count.clamp(min=1.0)
    cov = None
    if plain:
        cov = sums[7:].reshape(3, 3)
    elif kabsch:
        cov = reduce((((model_tmp - m_centroid) * w).T
                      @ ((cor_ref - r_centroid) * w)).reshape(9)
                     ).reshape(3, 3)
    return count, m_centroid, r_centroid, cov


def _kabsch(cov, m_centroid, r_centroid):
    """Alignment step (ICP.cpp:736-744): SVD of the covariance, R* = V U^T,
    T* = r_centroid - R* m_centroid."""
    u, _, vt = torch.linalg.svd(cov)
    r_opt = vt.T @ u.T
    t_opt = r_centroid - r_opt @ m_centroid
    finite = torch.isfinite(r_opt).all() & torch.isfinite(t_opt).all()
    return r_opt, t_opt, finite


def _icp_loop(ref, model, pair_mask, icp: cfg.IcpConfig, align,
              reduce=_local) -> IcpResult:
    """The shared loop.  ``align(first, model_tmp, dist_mean)`` returns
    (R*, T*, enough, finite) for one iteration, ``enough`` from reduced
    counts; the loop reads only reduced values, so ranks that hold slices
    of the pairs take the same branches."""
    dev = ref.device
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    zero3 = torch.zeros(3, dtype=torch.float32, device=dev)
    zmax = icp.valid_depth_max_mm
    dist_mean, ratio = _masked_pair_stats(model, ref, pair_mask, _FMAX, zmax,
                                          reduce)
    dist_diff = torch.tensor(_FMAX, dtype=torch.float32, device=dev)

    def more():
        return ((dist_mean > icp.dist_mean_threshold)
                & (dist_diff > icp.dist_diff_threshold))

    ok, go = torch.stack([reduce(pair_mask.sum()) >= icp.min_points,
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
                                                 3.0 * dist_mean, zmax, reduce)
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
                       pair_mask: torch.Tensor, icp: cfg.IcpConfig, *,
                       ref_all=None, reduce=_local) -> IcpResult:
    """ICP on index-paired, padded (P, 3) clouds (the reference's parity
    mode).  ``ref_all`` (default ``ref``) is the set the NN searches and
    ``reduce`` sums over the points: a point-sharded caller passes its
    slice of the pairs, the whole reference and an all-reduce
    (``parallel.sharded_icp``)."""
    ref_all = ref if ref_all is None else ref_all

    def align(first, model_tmp, dist_mean):
        if first:
            cor_ref, cor_mask = ref, pair_mask
        else:
            idx, cor_mask = _nn_pairs(model_tmp, ref_all, pair_mask,
                                      dist_mean, icp)
            cor_ref = ref_all.index_select(0, idx)
        count, m_centroid, r_centroid, cov = _moments(
            model_tmp, cor_ref, cor_mask, True, icp.centered_covariance,
            reduce)
        r_opt, t_opt, finite = _kabsch(cov, m_centroid, r_centroid)
        return r_opt, t_opt, count >= icp.min_points, finite

    return _icp_loop(ref, model, pair_mask, icp, align, reduce)


def _gauss_newton(model_tmp, cor_ref, cor_n, cor_mask, centroid,
                  icp: cfg.IcpConfig, reduce=_local):
    """Point-to-plane 6x6 normal equations about the model centroid, with
    the point-to-point anchor blend and per-diagonal damping (the JAX
    ``gn_update``); H and g of both blocks are reduced as one tensor."""
    w = cor_mask.to(torch.float32)[:, None]
    resid = (cor_n * (model_tmp - cor_ref)).sum(dim=1)
    jrow = torch.cat([torch.linalg.cross(model_tmp - centroid, cor_n, dim=1),
                      cor_n], dim=1)                              # (P, 6)
    jw = jrow * w
    parts = [(jw.T @ jw).reshape(36),
             (jw.T @ (resid * cor_mask)[:, None])[:, 0]]
    blend = icp.plane_point_blend > 0.0
    if blend:
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
        parts += [(j3w.T @ j3w).reshape(36), (j3w.T @ r3)[:, 0]]
    sums = reduce(torch.cat(parts))
    h, g = sums[:36].reshape(6, 6), sums[36:42]
    if blend:
        lam = icp.plane_point_blend
        h = h + lam * sums[42:78].reshape(6, 6)
        g = g + lam * sums[78:]
    damp = icp.plane_damping * torch.diag(torch.diagonal(h).clamp(min=1.0))
    # solve_ex: no error check, so no host sync (a singular system gives
    # non-finite values, which the caller's ``finite`` gate rejects)
    delta = torch.linalg.solve_ex(h + damp, -g)[0]
    omega, u = delta[:3], delta[3:]
    r_o = tf.so3_exp(omega)
    return r_o, u + centroid - r_o @ centroid, torch.isfinite(delta).all()


def icp_point_to_plane(ref: torch.Tensor, ref_normals: torch.Tensor,
                       model: torch.Tensor, pair_mask: torch.Tensor,
                       icp: cfg.IcpConfig, *, ref_all=None, normals_all=None,
                       reduce=_local) -> IcpResult:
    """Point-to-plane ICP via 6x6 Gauss-Newton normal equations, with the
    JAX version's degeneracy gate: when the valid normals' scatter is
    near-planar (lambda1 <= plane_min_normal_anisotropy * lambda2) every
    step takes the Kabsch update instead.  The gate is read on the host
    once per refine, so only the selected update runs.  ``ref_all`` /
    ``normals_all`` and ``reduce`` as in :func:`icp_point_to_point`."""
    ref_all = ref if ref_all is None else ref_all
    normal_ok_ref = (ref_normals * ref_normals).sum(dim=1) > 0.25
    if normals_all is None:
        normals_all, normal_ok_all = ref_normals, normal_ok_ref
    else:
        normal_ok_all = (normals_all * normals_all).sum(dim=1) > 0.25
    nmask = (pair_mask & normal_ok_ref
             & (ref[:, 2] <= icp.valid_depth_max_mm))
    nw = nmask.to(torch.float32)[:, None]
    sums = reduce(torch.cat([
        ((ref_normals * nw).T @ (ref_normals * nw)).reshape(9), nw.sum(0)]))
    scatter = sums[:9].reshape(3, 3) / sums[9].clamp(min=1.0)
    evals = torch.linalg.eigvalsh(scatter)            # ascending
    plane_ok = bool(evals[1] > icp.plane_min_normal_anisotropy * evals[2])

    def align(first, model_tmp, dist_mean):
        if first:
            cor_ref, cor_n = ref, ref_normals
            cor_mask = pair_mask & normal_ok_ref
        else:
            idx, keep = _nn_pairs(model_tmp, ref_all, pair_mask, dist_mean,
                                  icp)
            cor_mask = keep & normal_ok_all.index_select(0, idx)
            cor_ref = ref_all.index_select(0, idx)
            cor_n = normals_all.index_select(0, idx)
        count, centroid, r_centroid, cov = _moments(
            model_tmp, cor_ref, cor_mask, not plane_ok,
            icp.centered_covariance, reduce)
        if plane_ok:
            r_opt, t_opt, finite = _gauss_newton(model_tmp, cor_ref, cor_n,
                                                 cor_mask, centroid, icp,
                                                 reduce)
        else:
            r_opt, t_opt, finite = _kabsch(cov, centroid, r_centroid)
        return r_opt, t_opt, count >= icp.min_points, finite

    return _icp_loop(ref, model, pair_mask, icp, align, reduce)


def icp_refine(ref, model, pair_mask, icp: cfg.IcpConfig,
               ref_normals=None) -> IcpResult:
    """Mode dispatcher: ``icp.mode`` selects point-to-point (reference
    parity) or point-to-plane (requires ``ref_normals``)."""
    if icp.mode == "point_to_plane":
        if ref_normals is None:
            raise ValueError("point_to_plane mode needs ref_normals")
        return icp_point_to_plane(ref, ref_normals, model, pair_mask, icp)
    return icp_point_to_point(ref, model, pair_mask, icp)
