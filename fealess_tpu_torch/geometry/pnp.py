"""EPnP pose from 3D-2D correspondences and the Rodrigues conversions, in
float64 numpy on the host (the port's counterpart of the
``cv2.solvePnP(..., flags=SOLVEPNP_EPNP)`` and ``cv2.Rodrigues`` calls of
``ObjReco.compute_pose_epnp``; the card has no cv2).

:func:`solve_pnp_epnp` follows OpenCV's EPnP (Lepetit, Moreno-Noguer and
Fua, IJCV 2009, as ``calib3d``'s ``epnp.cpp`` implements it) step for step,
so that noisy correspondences give OpenCV's pose and not merely a pose:

- the image points go to normalized coordinates first, ``(u - cx) *
  (1 / fx)``, are stored in the image points' own dtype, and come back to
  pixels as ``x * fx + cx`` (``undistortPoints`` without distortion, then
  the solver's own projection);
- four control points: the centroid of the world points and the centroid
  plus ``sqrt(lambda_i / n)`` times each principal axis;
- barycentric coordinates through the SVD pseudo-inverse of the control
  points' 3x3 offsets (singular values at or below ``2 eps`` times their
  sum are dropped, so a planar set gets a zero fourth coordinate);
- the 2n x 12 system M, the four singular vectors of ``M^T M`` with the
  smallest singular values, the 6 x 10 matrix L and the six squared control
  point distances rho;
- the three beta approximations (least squares through the same
  pseudo-inverse rule), each refined by five Gauss-Newton steps solved by
  OpenCV's Householder QR, then R and t by the SVD of the centred cross
  covariance (the third row of R negated when its determinant is
  negative); the smallest mean reprojection error wins, the earlier
  approximation on a tie.

The sign of a null-space vector does not change the result: each beta
approximation and Gauss-Newton step is odd in the flipped vector's
coefficients, and a negative depth of the first point flips the whole
solution.  The signs of the principal axes do (they move the control
points), so those come from OpenCV's own one-sided Jacobi SVD
(:func:`_jacobi_svd`).  Below 6 points M^T M has an exact null space of
dimension 12 - 2n, and which basis of it an SVD returns is that SVD's
rounding: there the pose is a valid EPnP pose but not OpenCV's.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

_EPS2 = 2.0 * np.finfo(np.float64).eps
_GAUSS_NEWTON_STEPS = 5


def _svd_solve(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Least-squares (pseudo-inverse) solution of ``a x = b`` by SVD,
    dropping singular values ``<= 2 eps * sum(singular values)``
    (``cv::SVD::backSubst``, as ``cvSolve``/``cvInvert`` with CV_SVD use
    it)."""
    u, w, vt = np.linalg.svd(a, full_matrices=False)
    keep = np.abs(w) > _EPS2 * w.sum()
    inv_w = np.where(keep, 1.0 / np.where(keep, w, 1.0), 0.0)
    if b.ndim == 2:
        inv_w = inv_w[:, None]
    return vt.T @ (inv_w * (u.T @ b))


def _jacobi_svd(a: np.ndarray):
    """(singular values, U^T) of a square matrix by OpenCV's one-sided
    Jacobi SVD (``JacobiSVDImpl_``, which ``cvSVD`` runs): the rows of
    ``a^T`` are rotated pairwise until orthogonal, sorted by norm and
    normalized.  Its singular vectors' signs are what the control points
    of :func:`epnp_pose` inherit, so numpy's LAPACK SVD, whose signs
    differ, cannot stand in for it there."""
    at = [[float(v) for v in row] for row in np.asarray(a, np.float64).T]
    n = len(at)
    w = [sum(v * v for v in row) for row in at]
    eps = 10 * np.finfo(np.float64).eps
    for _ in range(max(n, 30)):
        changed = False
        for i in range(n - 1):
            for j in range(i + 1, n):
                ai, aj = at[i], at[j]
                p = sum(x * y for x, y in zip(ai, aj))
                if abs(p) <= eps * math.sqrt(w[i] * w[j]):
                    continue
                p *= 2
                beta = w[i] - w[j]
                gamma = math.hypot(p, beta)
                if beta < 0:
                    s = math.sqrt((gamma - beta) * 0.5 / gamma)
                    c = p / (gamma * s * 2)
                else:
                    c = math.sqrt((gamma + beta) / (gamma * 2))
                    s = p / (gamma * c * 2)
                at[i] = [c * x + s * y for x, y in zip(ai, aj)]
                at[j] = [-s * x + c * y for x, y in zip(ai, aj)]
                w[i] = sum(v * v for v in at[i])
                w[j] = sum(v * v for v in at[j])
                changed = True
        if not changed:
            break
    w = [math.sqrt(sum(v * v for v in row)) for row in at]
    for i in range(n - 1):
        j = i
        for k in range(i + 1, n):
            if w[j] < w[k]:
                j = k
        if i != j:
            w[i], w[j] = w[j], w[i]
            at[i], at[j] = at[j], at[i]
    ut = np.array([[v * (1.0 / wi if wi > 0 else 0.0) for v in row]
                   for row, wi in zip(at, w)])
    return np.array(w), ut


def _qr_solve(a: np.ndarray, b: np.ndarray):
    """``epnp::qr_solve``: Householder QR of the 6 x 4 Gauss-Newton system,
    each column scaled by its largest magnitude over rows k..n-2 (the
    reference's scan stops one row short), then back substitution.  None
    when a column is zero: the caller then reuses its previous step, as the
    reference leaves its solution vector untouched."""
    a = a.copy()
    b = b.copy()
    nr, nc = a.shape
    a1 = np.zeros(nc)
    a2 = np.zeros(nc)
    for k in range(nc):
        eta = max(abs(a[k, k]), np.abs(a[k:nr - 1, k]).max(initial=0.0))
        if eta == 0:
            return None
        a[k:, k] *= 1.0 / eta
        sigma = np.sqrt(np.dot(a[k:, k], a[k:, k]))
        if a[k, k] < 0:
            sigma = -sigma
        a[k, k] += sigma
        a1[k] = sigma * a[k, k]
        a2[k] = -eta * sigma
        for j in range(k + 1, nc):
            tau = np.dot(a[k:, k], a[k:, j]) / a1[k]
            a[k:, j] -= tau * a[k:, k]
    for j in range(nc):
        tau = np.dot(a[j:, j], b[j:]) / a1[j]
        b[j:] -= tau * a[j:, j]
    x = np.zeros(nc)
    x[nc - 1] = b[nc - 1] / a2[nc - 1]
    for i in range(nc - 2, -1, -1):
        x[i] = (b[i] - np.dot(a[i, i + 1:], x[i + 1:])) / a2[i]
    return x


def _l_6x10(v: np.ndarray) -> np.ndarray:
    """``compute_L_6x10``: ``v`` holds the four null-space vectors (4, 12),
    the smallest singular value first."""
    pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    vv = v.reshape(4, 4, 3)
    dv = np.stack([vv[:, a] - vv[:, b] for a, b in pairs], axis=1)  # (4,6,3)
    out = np.empty((6, 10))
    cols = [(0, 0, 1.0), (0, 1, 2.0), (1, 1, 1.0), (0, 2, 2.0), (1, 2, 2.0),
            (2, 2, 1.0), (0, 3, 2.0), (1, 3, 2.0), (2, 3, 2.0), (3, 3, 1.0)]
    for c, (i, j, f) in enumerate(cols):
        out[:, c] = f * (dv[i] * dv[j]).sum(axis=1)
    return out


def _betas_approx_1(l6, rho):
    b4 = _svd_solve(l6[:, [0, 1, 3, 6]], rho)
    if b4[0] < 0:
        b0 = np.sqrt(-b4[0])
        return np.array([b0, -b4[1] / b0, -b4[2] / b0, -b4[3] / b0])
    b0 = np.sqrt(b4[0])
    return np.array([b0, b4[1] / b0, b4[2] / b0, b4[3] / b0])


def _betas_first_two(b):
    if b[0] < 0:
        b0 = np.sqrt(-b[0])
        b1 = np.sqrt(-b[2]) if b[2] < 0 else 0.0
    else:
        b0 = np.sqrt(b[0])
        b1 = np.sqrt(b[2]) if b[2] > 0 else 0.0
    if b[1] < 0:
        b0 = -b0
    return b0, b1


def _betas_approx_2(l6, rho):
    b0, b1 = _betas_first_two(_svd_solve(l6[:, :3], rho))
    return np.array([b0, b1, 0.0, 0.0])


def _betas_approx_3(l6, rho):
    b5 = _svd_solve(l6[:, :5], rho)
    b0, b1 = _betas_first_two(b5)
    return np.array([b0, b1, b5[3] / b0, 0.0])


def _gauss_newton(l6, rho, betas):
    """Five Gauss-Newton steps on ``L beta2 = rho`` in the four betas."""
    cols = [(0, 0), (0, 1), (1, 1), (0, 2), (1, 2), (2, 2), (0, 3), (1, 3),
            (2, 3), (3, 3)]
    step = np.zeros(4)
    for _ in range(_GAUSS_NEWTON_STEPS):
        a = np.zeros((6, 4))
        quad = np.zeros(6)
        for c, (i, j) in enumerate(cols):
            quad += l6[:, c] * betas[i] * betas[j]
            if i == j:
                a[:, i] += 2 * l6[:, c] * betas[i]
            else:
                a[:, i] += l6[:, c] * betas[j]
                a[:, j] += l6[:, c] * betas[i]
        solved = _qr_solve(a, rho - quad)
        if solved is not None:
            step = solved
        betas = betas + step
    return betas


def _r_and_t(v, betas, alphas, pws, us, cam):
    """``compute_R_and_t``: control points in the camera frame from the
    betas, the points' camera coordinates, the sign fix, Procrustes; and
    the mean reprojection error."""
    ccs = (betas[:, None] * v).sum(axis=0).reshape(4, 3)
    pcs = alphas @ ccs
    if pcs[0, 2] < 0.0:
        pcs = -pcs
    pc0 = pcs.mean(axis=0)
    pw0 = pws.mean(axis=0)
    abt = (pcs - pc0).T @ (pws - pw0)
    u, _, vt = np.linalg.svd(abt)
    r = u @ vt
    if np.linalg.det(r) < 0:
        r[2] = -r[2]
    t = pc0 - r @ pw0
    fu, fv, uc, vc = cam
    xc = pws @ r.T + t
    inv_z = 1.0 / xc[:, 2]
    ue = uc + fu * xc[:, 0] * inv_z
    ve = vc + fv * xc[:, 1] * inv_z
    err = np.sqrt((us[:, 0] - ue) ** 2 + (us[:, 1] - ve) ** 2).mean()
    return r, t, err


def epnp_pose(object_points: np.ndarray, image_points: np.ndarray,
              k: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(R (3, 3), t (3,)) in float64 that map ``object_points`` (n, 3)
    onto ``image_points`` (n, 2) through the pinhole ``k``; n >= 4."""
    k = np.asarray(k, np.float64)
    fu, fv, uc, vc = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
    img = np.asarray(image_points)
    pws = np.asarray(object_points).reshape(-1, 3).astype(np.float64)
    n = len(pws)
    if n < 4 or len(img.reshape(-1, 2)) != n:
        raise ValueError(f"EPnP needs n >= 4 matching points, got {n} 3D "
                         f"and {len(img.reshape(-1, 2))} 2D")
    # normalized coordinates in the image points' dtype, back to pixels
    uv = img.reshape(-1, 2).astype(np.float64)
    dt = img.dtype if img.dtype in (np.float32, np.float64) else np.float64
    xn = ((uv[:, 0] - uc) * (1.0 / fu)).astype(dt).astype(np.float64)
    yn = ((uv[:, 1] - vc) * (1.0 / fv)).astype(dt).astype(np.float64)
    us = np.stack([xn * fu + uc, yn * fv + vc], axis=1)

    # control points: centroid + scaled principal axes
    c0 = pws.mean(axis=0)
    pw0 = pws - c0
    dc, uct = _jacobi_svd(pw0.T @ pw0)
    cws = np.empty((4, 3))
    cws[0] = c0
    for i in range(1, 4):
        cws[i] = c0 + np.sqrt(dc[i - 1] / n) * uct[i - 1]
    # barycentric coordinates
    cc = (cws[1:] - c0).T
    cc_inv = _svd_solve(cc, np.eye(3))
    alphas = np.empty((n, 4))
    alphas[:, 1:] = pw0 @ cc_inv.T
    alphas[:, 0] = 1.0 - alphas[:, 1] - alphas[:, 2] - alphas[:, 3]

    # M (2n x 12) and the null space of M^T M
    m = np.zeros((2 * n, 12))
    for i in range(4):
        m[0::2, 3 * i] = alphas[:, i] * fu
        m[0::2, 3 * i + 2] = alphas[:, i] * (uc - us[:, 0])
        m[1::2, 3 * i + 1] = alphas[:, i] * fv
        m[1::2, 3 * i + 2] = alphas[:, i] * (vc - us[:, 1])
    mtm = m.T @ m
    ut = np.linalg.svd(mtm)[0].T
    v = ut[[11, 10, 9, 8]]
    l6 = _l_6x10(v)
    rho = np.array([((cws[a] - cws[b]) ** 2).sum() for a, b in
                    [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]])

    best = None
    for approx in (_betas_approx_1, _betas_approx_2, _betas_approx_3):
        betas = _gauss_newton(l6, rho, approx(l6, rho))
        r, t, err = _r_and_t(v, betas, alphas, pws, us, (fu, fv, uc, vc))
        if best is None or err < best[2]:
            best = (r, t, err)
    return best[0], best[1]


def rodrigues(src: np.ndarray) -> np.ndarray:
    """``cv2.Rodrigues`` in float64: a rotation vector (3,) or (3, 1) gives
    its 3x3 matrix; a 3x3 matrix (re-orthonormalized by SVD first) gives
    its rotation vector (3, 1)."""
    src = np.asarray(src, np.float64)
    if src.size == 3:
        r = src.reshape(3)
        theta = np.sqrt(np.dot(r, r))
        if theta < np.finfo(np.float64).eps:
            return np.eye(3)
        c, s = np.cos(theta), np.sin(theta)
        r = r * (1.0 / theta)
        rx = np.array([[0.0, -r[2], r[1]], [r[2], 0.0, -r[0]],
                       [-r[1], r[0], 0.0]])
        return c * np.eye(3) + (1.0 - c) * np.outer(r, r) + s * rx
    if src.shape != (3, 3):
        raise ValueError(f"rodrigues takes a 3-vector or a 3x3 matrix, got "
                         f"shape {src.shape}")
    u, _, vt = np.linalg.svd(src)
    rot = u @ vt
    r = np.array([rot[2, 1] - rot[1, 2], rot[0, 2] - rot[2, 0],
                  rot[1, 0] - rot[0, 1]])
    s = np.sqrt(np.dot(r, r) * 0.25)
    c = min(max((rot[0, 0] + rot[1, 1] + rot[2, 2] - 1.0) * 0.5, -1.0), 1.0)
    theta = np.arccos(c)
    if s < 1e-5:
        if c > 0:
            return np.zeros((3, 1))
        r = np.array([np.sqrt(max((rot[0, 0] + 1.0) * 0.5, 0.0)),
                      np.sqrt(max((rot[1, 1] + 1.0) * 0.5, 0.0))
                      * (-1.0 if rot[0, 1] < 0 else 1.0),
                      np.sqrt(max((rot[2, 2] + 1.0) * 0.5, 0.0))
                      * (-1.0 if rot[0, 2] < 0 else 1.0)])
        if (abs(r[0]) < abs(r[1]) and abs(r[0]) < abs(r[2])
                and (rot[1, 2] > 0) != (r[1] * r[2] > 0)):
            r[2] = -r[2]
        return (r * (theta / np.sqrt(np.dot(r, r)))).reshape(3, 1)
    vth = 1.0 / (2.0 * s)
    return (r * (vth * theta)).reshape(3, 1)


def solve_pnp_epnp(object_points: np.ndarray, image_points: np.ndarray,
                   k: np.ndarray):
    """``cv2.solvePnP(object_points, image_points, k, None,
    flags=cv2.SOLVEPNP_EPNP)`` without distortion: (True, rvec (3, 1),
    tvec (3, 1)), both float64."""
    r, t = epnp_pose(object_points, image_points, k)
    return True, rodrigues(r), t.reshape(3, 1)
