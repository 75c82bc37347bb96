"""Batched EPnP + RANSAC for relocalization (port of
``orbslam2_tpu.ops.pnp``), the plain version of kernel Z
(``kernels/pnp_ransac.py``).

Every hypothesis runs the reference's EPnP on its 4-point sample: PCA
control points, barycentric coordinates, the null space of the 12x12 M^T M,
the three beta cases seeded from the 6 x 10 distance system, 5 Gauss-Newton
iterations each, Horn's alignment of the control points and the lowest
reprojection SSE. Then the chi2 < 5.991 inliers of every hypothesis, the
one with the most (the first on ties, non-finite ones at -1), a weighted
EPnP over all its inliers (the reference's Refine), its recount, and the
better of the two.

Precision: the reference solves in float32; its eigh of the rank-8 M^T M of
a minimal set is accurate to float32 rounding times the matrix's condition,
so its null-space basis, and the poses of hypotheses whose Gauss-Newton has
not converged, move with the rounding. Here (and in kernel Z) the EPnP
solves run in float64 and the inlier counts in float32, in the reference's
expression order. With noise the solution depends on the signs of the PCA
axes, which the reference takes as its eigen-solver gives them and the port
fixes (``pca``): with LAPACK's signs the two agree within 1e-4, with the
port's within the noise (ROADMAP queue 3, "PnP control points").
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.camera import Camera
from . import geometry as geo

SAMPLE_SIZE = 4     # the minimal set
N_GN_ITERS = 5      # Gauss-Newton iterations on the betas
CHI2_PNP = 5.991

# the 6 control-point pairs (i < j), and the columns of the 6 x 10 system
# [b11, b12, b22, b13, b23, b33, b14, b24, b34, b44] (the EPnP paper's order)
PAIR_I = (0, 0, 0, 1, 1, 2)
PAIR_J = (1, 2, 3, 2, 3, 3)
L_I = (0, 0, 1, 0, 1, 2, 0, 1, 2, 3)
L_J = (0, 1, 1, 2, 2, 2, 3, 3, 3, 3)


class PnPResult(NamedTuple):
    Tcw: torch.Tensor        # (4, 4) float32
    inliers: torch.Tensor    # (N,) bool
    n_inliers: torch.Tensor  # () int32
    ok: torch.Tensor         # () bool: at least min_inliers inliers


def _eigh(A: torch.Tensor):
    """torch.linalg.eigh of a batch, with non-finite matrices replaced by
    the identity and their results set to NaN (LAPACK refuses them)."""
    bad = ~torch.isfinite(A).all(-1).all(-1)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    ev, V = torch.linalg.eigh(torch.where(bad[..., None, None], eye, A))
    return (torch.where(bad[..., None], float("nan"), ev),
            torch.where(bad[..., None, None], float("nan"), V))


def _solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A^-1 b, with no error on a singular A (its result is non-finite)."""
    return torch.linalg.solve_ex(A, b)[0]


def pca(cov: torch.Tensor):
    """Eigenvalues (ascending) and eigenvectors of (B, 3, 3) covariances,
    each eigenvector signed so that its largest-magnitude component (the
    first of equal ones) is positive. The control points, and with noise the
    EPnP solution, depend on these signs; an eigen-solver's own signs are
    arbitrary (MKL's, LAPACK's and kernel Z's Jacobi differ), so the port
    fixes them."""
    evals, evecs = _eigh(cov)
    lead = evecs.gather(-2, evecs.abs().argmax(-2, keepdim=True))
    return evals, evecs * torch.where(lead < 0, -1.0, 1.0)


def control_points(pts: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, 3) points, (B, S) weights -> (B, 4, 3): the weighted centroid
    and the centroid plus each PCA axis scaled by sqrt(eigenvalue)."""
    sw = w.sum(-1).clamp_min(1e-9)
    c0 = (pts * w[..., None]).sum(-2) / sw[..., None]
    centered = (pts - c0[..., None, :]) * torch.sqrt(w)[..., None]
    cov = centered.transpose(-1, -2) @ centered / sw[..., None, None]
    evals, evecs = pca(cov)
    axes = evecs * torch.sqrt(evals.clamp_min(1e-9))[..., None, :]
    return torch.cat([c0[..., None, :], c0[..., None, :] + axes.transpose(-1, -2)], -2)


def _betas_from_L(L: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """(B, 6, 10), (B, 6) -> the (B, 3, 4) seeds of the three cases."""

    def lsq(cols):
        A = L[..., list(cols)]
        AtA = A.transpose(-1, -2) @ A + 1e-9 * torch.eye(
            len(cols), dtype=L.dtype, device=L.device)
        return _solve(AtA, (A.transpose(-1, -2) @ rho[..., None])[..., 0])

    one = torch.ones_like(rho[..., 0])
    b = lsq((0, 1, 3, 6))                                   # b11 b12 b13 b14
    beta1 = torch.sqrt(b[..., 0].abs())
    s1 = torch.where(b[..., 0] < 0, -one, one)
    div = torch.where(beta1 > 1e-9, beta1, one)
    case1 = torch.stack([beta1, s1 * b[..., 1] / div, s1 * b[..., 2] / div,
                         s1 * b[..., 3] / div], -1)
    b = lsq((0, 1, 2))                                      # b11 b12 b22
    beta1 = torch.sqrt(b[..., 0].abs())
    beta2 = torch.sqrt(b[..., 2].abs())
    beta2 = torch.where(b[..., 1] < 0, -beta2, beta2)
    zero = torch.zeros_like(beta1)
    case2 = torch.stack([beta1, beta2, zero, zero], -1)
    b = lsq((0, 1, 2, 3, 4))                                # b11 b12 b22 b13 b23
    beta1 = torch.sqrt(b[..., 0].abs())
    beta2 = torch.where(b[..., 1] < 0, -one, one) * torch.sqrt(b[..., 2].abs())
    beta3 = b[..., 3] / torch.where(beta1 > 1e-9, beta1, one)
    case3 = torch.stack([beta1, beta2, beta3, zero], -1)
    return torch.stack([case1, case2, case3], -2)


def _gauss_newton(dv: torch.Tensor, rho: torch.Tensor, betas: torch.Tensor):
    """Refine betas (B, 3, 4) on the 6 distance constraints; dv (B, 4, 6,
    3) holds each null vector's 6 control-point differences."""
    eye = torch.eye(4, dtype=dv.dtype, device=dv.device)
    dv = dv[:, None]                                        # (B, 1, 4, 6, 3)
    for _ in range(N_GN_ITERS):
        s = (betas[..., None, None] * dv).sum(-3)           # (B, 3, 6, 3)
        e = (s * s).sum(-1) - rho[:, None]                  # (B, 3, 6)
        J = 2.0 * (s[..., None, :, :] * dv).sum(-1).transpose(-1, -2)  # (B, 3, 6, 4)
        JtJ = J.transpose(-1, -2) @ J + 1e-6 * eye
        betas = betas - _solve(JtJ, (J.transpose(-1, -2) @ e[..., None])[..., 0])
    return betas


def normal_matrices(pts_w: torch.Tensor, obs_uv: torch.Tensor, w: torch.Tensor,
                    cam: Camera):
    """EPnP's linear system for a batch of weighted point sets: (B, S, 3)
    world points, (B, S, 2) pixels, (B, S) weights in [0, 1] -> control
    points Cw (B, 4, 3), barycentric coordinates (B, S, 4) and M^T M (B,
    12, 12), the rows of M scaled by sqrt(w)."""
    B, S = pts_w.shape[:2]
    dt, dev = pts_w.dtype, pts_w.device
    Cw = control_points(pts_w, w)                            # (B, 4, 3)
    ones4 = torch.ones((B, 1, 4), dtype=dt, device=dev)
    CwH = torch.cat([Cw.transpose(-1, -2), ones4], -2)       # (B, 4, 4)
    XH = torch.cat([pts_w.transpose(-1, -2),
                    torch.ones((B, 1, S), dtype=dt, device=dev)], -2)
    alphas = _solve(CwH, XH).transpose(-1, -2)               # (B, S, 4)

    fu, fv, uc, vc = cam.fx, cam.fy, cam.cx, cam.cy
    u, v = obs_uv[..., 0], obs_uv[..., 1]
    zero = torch.zeros_like(alphas)
    sw = torch.sqrt(w.clamp_min(0.0))[..., None]
    r1 = torch.stack([alphas * fu, zero, alphas * (uc - u)[..., None]],
                     -1).reshape(B, S, 12) * sw
    r2 = torch.stack([zero, alphas * fv, alphas * (vc - v)[..., None]],
                     -1).reshape(B, S, 12) * sw
    M = torch.cat([r1, r2], -2)                              # (B, 2S, 12)
    return Cw, alphas, M.transpose(-1, -2) @ M


def epnp_weighted(pts_w: torch.Tensor, obs_uv: torch.Tensor, w: torch.Tensor,
                  cam: Camera) -> torch.Tensor:
    """EPnP on a batch of weighted point sets (``normal_matrices``' inputs)
    -> (B, 4, 4) Tcw, in the dtype of the inputs (float64 here)."""
    B = pts_w.shape[0]
    dt, dev = pts_w.dtype, pts_w.device
    u, v = obs_uv[..., 0], obs_uv[..., 1]
    fu, fv, uc, vc = cam.fx, cam.fy, cam.cx, cam.cy
    Cw, alphas, MtM = normal_matrices(pts_w, obs_uv, w, cam)
    _, V = _eigh(MtM)
    vbasis = V[..., :4].transpose(-1, -2).reshape(B, 4, 4, 3)

    pi, pj = list(PAIR_I), list(PAIR_J)
    dv = vbasis[:, :, pi] - vbasis[:, :, pj]                 # (B, 4, 6, 3)
    dw = Cw[:, pi] - Cw[:, pj]
    rho = (dw * dw).sum(-1)                                  # (B, 6)
    coef = torch.tensor([1.0 if i == j else 2.0 for i, j in zip(L_I, L_J)],
                        dtype=dt, device=dev)
    L = coef * (dv[:, list(L_I)] * dv[:, list(L_J)]).sum(-1).transpose(-1, -2)
    betas = _gauss_newton(dv, rho, _betas_from_L(L, rho))    # (B, 3, 4)

    Cc = (betas[..., None, None] * vbasis[:, None]).sum(2)   # (B, 3, 4, 3)
    pc = alphas[:, None] @ Cc                                # (B, 3, S, 3)
    depth = (pc[..., 2] * w[:, None]).sum(-1)
    Cc = Cc * torch.where(depth < 0, -1.0, 1.0)[..., None, None]
    _, R, t = geo.horn_align(Cw[:, None].expand(B, 3, 4, 3), Cc, with_scale=False)
    T = geo.se3_from_rt(R, t)                                # (B, 3, 4, 4)
    pcam = pts_w[:, None] @ R.transpose(-1, -2) + t[..., None, :]
    z = pcam[..., 2].clamp_min(1e-6)
    du = fu * pcam[..., 0] / z + uc - u[:, None]
    dvv = fv * pcam[..., 1] / z + vc - v[:, None]
    sse = ((du * du + dvv * dvv) * w[:, None]).sum(-1)
    finite = torch.isfinite(T).all(-1).all(-1)
    sse = torch.where(finite & ~torch.isnan(sse), sse, torch.full_like(sse, float("inf")))
    best = sse.argmin(-1)
    return T[torch.arange(B, device=dev), best]


def count_inliers(T: torch.Tensor, cam: Camera, pts_w, obs_uv, sigma2, valid):
    """(B, 4, 4) float32 poses -> (inliers (B, N) bool, counts (B,) int32):
    depth > 0.05 and chi2 < 5.991, in float32, the camera-frame point
    written term by term as kernel Z computes it."""
    R, t = T[:, None, :3, :3], T[:, None, :3, 3]
    x, y, zc = (R[..., i, 0] * pts_w[:, 0] + R[..., i, 1] * pts_w[:, 1]
                + R[..., i, 2] * pts_w[:, 2] + t[..., i] for i in range(3))
    z = zc.clamp_min(1e-6)
    u = cam.fx * x / z + cam.cx
    v = cam.fy * y / z + cam.cy
    du, dv = u - obs_uv[:, 0], v - obs_uv[:, 1]
    chi2 = (du * du + dv * dv) / sigma2
    inl = valid & (zc > 0.05) & (chi2 < CHI2_PNP)
    return inl, inl.sum(-1).to(torch.int32)


def hypotheses(cam: Camera, pts_w, obs_uv, samples) -> torch.Tensor:
    """(I, 4, 4) float32 poses of the samples' EPnP, solved in float64."""
    s = samples.long()
    P = pts_w.double()[s]
    ones = torch.ones(s.shape, dtype=torch.float64, device=pts_w.device)
    return epnp_weighted(P, obs_uv.double()[s], ones, cam).float()


def pnp_ransac(cam: Camera, pts_w, obs_uv, sigma2, valid, samples,
               min_inliers: int = 10) -> PnPResult:
    """All hypotheses of ``samples`` (I, 4) int32 over the (N, 3) points,
    (N, 2) pixels, (N,) sigma^2 and validity, the best by inlier count, its
    all-inlier refine, and the better of the two."""
    hyp = hypotheses(cam, pts_w, obs_uv, samples)
    inls, counts = count_inliers(hyp, cam, pts_w, obs_uv, sigma2, valid)
    finite = torch.isfinite(hyp.reshape(hyp.shape[0], -1)).all(-1)
    counts = torch.where(finite, counts, torch.full_like(counts, -1))
    best = int(counts.argmax())
    T_best, inl_best, n_best = hyp[best], inls[best], counts[best]
    w = (inl_best & valid).double()
    T_ref = epnp_weighted(pts_w.double()[None], obs_uv.double()[None], w[None],
                          cam).float()
    inl_ref, n_ref = count_inliers(T_ref, cam, pts_w, obs_uv, sigma2, valid)
    n_ref = torch.where(torch.isfinite(T_ref).all(), n_ref[0], n_ref.new_tensor(-1))
    use_ref = bool(n_ref >= n_best)
    return PnPResult(
        Tcw=T_ref[0] if use_ref else T_best,
        inliers=inl_ref[0] if use_ref else inl_best,
        n_inliers=n_ref if use_ref else n_best,
        ok=torch.maximum(n_ref, n_best) >= min_inliers)
