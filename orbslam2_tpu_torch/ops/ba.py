"""Bundle adjustment: Levenberg-Marquardt with the landmark Schur complement
(port of ``orbslam2_tpu.ops.ba``, plain PyTorch).

Per observation: residual, Jp (3x6 pose), Jl (3x3 point) and a Huber
weight; per landmark D (3x3) and its damped adjugate inverse; per camera
H_cc and b_c; then the dense reduced system

    S = blockdiag(H_cc) - sum_m E_m D_m^-1 E_m^T      (6K x 6K)

solved by Cholesky, and the landmarks back-substituted. Tensors keep the
ordinary layout: points, observation slots, then the block, e.g. Jp is
(M, O, 3, 6), so each block product is one batched matmul. The camera
reductions are products with a 0/1 (M, O, K) incidence tensor, so they are
deterministic on the card.

Schedule (the reference's): ``iters`` Huber iterations, then per outlier
round a chi2 classification and ``iters // 2`` iterations on the inliers
without the robust kernel. Each phase restarts lambda at 1e-4 and is split
into a bulk part and a 3-iteration tail, as the reference's mixed-precision
schedule is; here both parts run in float32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import geometry as geo
from ..models.camera import Camera

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
TAIL_ITERS = 3


class BAProblem(NamedTuple):
    poses: torch.Tensor       # (K, 4, 4) Tcw
    opt_mask: torch.Tensor    # (K,) bool: optimize this camera
    points: torch.Tensor      # (M, 3)
    point_valid: torch.Tensor  # (M,)
    obs_kf: torch.Tensor      # (M, O) int32 camera index (-1 = none)
    obs_uvr: torch.Tensor     # (M, O, 3) measured (u, v, u_right); ur < 0 mono
    obs_sigma2: torch.Tensor  # (M, O)
    obs_valid: torch.Tensor   # (M, O) bool


class BAResult(NamedTuple):
    poses: torch.Tensor
    points: torch.Tensor
    obs_inlier: torch.Tensor  # (M, O) bool final chi2 classification
    cost: torch.Tensor        # () final robust cost


class _Obs(NamedTuple):
    """Loop-invariant observation data."""
    onehot: torch.Tensor     # (M, O, K) 0/1 camera incidence (0 for kf < 0)
    kidx: torch.Tensor       # (M, O) long camera index, clamped to >= 0
    uvr: torch.Tensor        # (M, O, 3)
    sigma2: torch.Tensor     # (M, O)
    is_stereo: torch.Tensor  # (M, O) bool


def _prepare(prob: BAProblem) -> _Obs:
    K = prob.poses.shape[0]
    kf = prob.obs_kf.long()
    ar = torch.arange(K, device=kf.device)
    onehot = ((kf.clamp_min(0)[..., None] == ar) & (kf >= 0)[..., None]).to(
        prob.poses.dtype)
    return _Obs(onehot=onehot, kidx=kf.clamp_min(0), uvr=prob.obs_uvr,
                sigma2=prob.obs_sigma2, is_stereo=prob.obs_uvr[..., 2] >= 0)


def _project(cam: Camera, poses, points, ob: _Obs, with_jac: bool = True):
    """Residuals r (M, O, 3), Jacobians Jp (M, O, 3, 6) for a left twist on
    the observing camera and Jl (M, O, 3, 3) for the point, clamped depth
    z (M, O)."""
    T = poses[ob.kidx]                                          # (M, O, 4, 4)
    R = T[..., :3, :3]
    pc = (R @ points[:, None, :, None])[..., 0] + T[..., :3, 3]  # (M, O, 3)
    x, y = pc[..., 0], pc[..., 1]
    z = pc[..., 2].clamp_min(1e-6)
    inv_z = 1.0 / z
    inv_z2 = inv_z * inv_z
    u = cam.fx * x * inv_z + cam.cx
    v = cam.fy * y * inv_z + cam.cy
    st = ob.is_stereo
    zero = torch.zeros_like(z)
    r = torch.stack([u - ob.uvr[..., 0], v - ob.uvr[..., 1],
                     torch.where(st, (u - cam.bf * inv_z) - ob.uvr[..., 2], zero)],
                    -1)
    if not with_jac:
        return r, None, None, z
    stf = st.to(z.dtype)
    j00 = cam.fx * inv_z
    j02 = -cam.fx * x * inv_z2
    Jpix = torch.stack([
        torch.stack([j00, zero, j02], -1),
        torch.stack([zero, cam.fy * inv_z, -cam.fy * y * inv_z2], -1),
        torch.stack([stf * j00, zero, stf * (j02 + cam.bf * inv_z2)], -1),
    ], -2)                                                      # (M, O, 3, 3)
    # d(pc)/d(xi) = [I | -hat(pc)], with the clamped depth (left twist)
    pcz = torch.stack([x, y, z], -1)
    eye = torch.eye(3, dtype=z.dtype, device=z.device).expand(pcz.shape + (3,))
    Jpose = torch.cat([eye, -geo.hat(pcz)], -1)                 # (M, O, 3, 6)
    return r, Jpix @ Jpose, Jpix @ R, z


def _robust(r, ob: _Obs, valid, z, use_huber: bool):
    """Huber weights, chi2 (both (M, O)) and the robust cost."""
    s2 = ob.sigma2.clamp_min(1e-12)
    chi2 = (r * r).sum(-1) / s2
    delta2 = torch.where(ob.is_stereo, CHI2_STEREO, CHI2_MONO)
    one = torch.ones_like(chi2)
    w_h = torch.where(chi2 <= delta2, one,
                      torch.sqrt(delta2 / chi2.clamp_min(1e-12)))
    w = (w_h if use_huber else one) / s2
    w = torch.where(valid & (z > 1e-5), w, torch.zeros_like(w))
    if use_huber:
        rho = torch.where(chi2 <= delta2, chi2,
                          2.0 * torch.sqrt(delta2 * chi2.clamp_min(1e-12)) - delta2)
    else:
        rho = chi2.clamp_max(1e6)
    cost = torch.where(valid, rho, torch.zeros_like(rho)).sum()
    return w, chi2, cost


def _cost(cam, poses, points, ob, valid, use_huber):
    r, _, _, z = _project(cam, poses, points, ob, with_jac=False)
    _, chi2, cost = _robust(r, ob, valid, z, use_huber)
    return cost, chi2


def _damped_inv3(D, lam, point_valid):
    """Adjugate inverse of D + damp I per landmark, damp = (lam + 1e-9) *
    max(trace(D)/3, 1e-6) + 1e-8; zero for invalid landmarks."""
    trD = D[:, 0, 0] + D[:, 1, 1] + D[:, 2, 2]
    damp = (1e-9 + lam) * (trD / 3.0).clamp_min(1e-6) + 1e-8
    Dd = D + damp[:, None, None] * torch.eye(3, dtype=D.dtype, device=D.device)
    a, b, c = Dd[:, 0, 0], Dd[:, 0, 1], Dd[:, 0, 2]
    d, e, f = Dd[:, 1, 0], Dd[:, 1, 1], Dd[:, 1, 2]
    g, h, i = Dd[:, 2, 0], Dd[:, 2, 1], Dd[:, 2, 2]
    co = torch.stack([
        torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1),
    ], -2)
    det = a * co[:, 0, 0] + b * co[:, 1, 0] + c * co[:, 2, 0]
    safe = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    inv_det = torch.where(point_valid, 1.0 / safe, torch.zeros_like(det))
    return co * inv_det[:, None, None]


def _schur_solve(S, b_S, opt_mask, lam):
    """Fix non-optimized cameras, damp, and Cholesky-solve S dc = -b_S."""
    K = opt_mask.shape[0]
    fixedv = (~opt_mask).repeat_interleave(6)
    keep = (~fixedv[:, None]) & (~fixedv[None, :])
    S = torch.where(keep, S, torch.zeros_like(S)) + torch.diag(fixedv.to(S.dtype))
    b_S = torch.where(fixedv, torch.zeros_like(b_S), b_S)
    d = torch.diagonal(S)
    tr_k = d.reshape(K, 6).mean(1)
    add = lam * tr_k.clamp_min(1e-6)
    Sd = S + torch.diag(add.repeat_interleave(6))
    Sd = 0.5 * (Sd + Sd.T)
    # cholesky_ex neither raises nor synchronises; a failed factorization
    # yields NaN steps, which the cost test rejects (as the reference's NaN
    # Cholesky does)
    L, info = torch.linalg.cholesky_ex(Sd)
    dc = -torch.cholesky_solve(b_S[:, None], L)[:, 0]
    dc = torch.where(info > 0, torch.full_like(dc, float("nan")), dc)
    dc = torch.where(fixedv, torch.zeros_like(dc), dc).reshape(K, 6)
    return torch.where(opt_mask[:, None], dc, torch.zeros_like(dc))


def _build_and_solve(cam, poses, points, prob: BAProblem, ob: _Obs, valid,
                     use_huber, lam):
    """One LM step: normal equations, Schur solve, back-substitution."""
    K = poses.shape[0]
    M = points.shape[0]
    r, Jp, Jl, z = _project(cam, poses, points, ob)
    w, _, _ = _robust(r, ob, valid, z, use_huber)
    Jpw_t = (Jp * w[..., None, None]).transpose(-1, -2)         # (M, O, 6, 3)
    Jlw_t = (Jl * w[..., None, None]).transpose(-1, -2)         # (M, O, 3, 3)
    r_c = r[..., None]

    # camera blocks and landmark blocks
    H_cc = torch.einsum("mok,moij->kij", ob.onehot, Jpw_t @ Jp)  # (K, 6, 6)
    b_c = torch.einsum("mok,moi->ki", ob.onehot, (Jpw_t @ r_c)[..., 0])
    D = (Jlw_t @ Jl).sum(1)                                     # (M, 3, 3)
    b_l = (Jlw_t @ r_c)[..., 0].sum(1)                          # (M, 3)
    E = Jpw_t @ Jl                                              # (M, O, 6, 3)
    Dinv = _damped_inv3(D, lam, prob.point_valid)
    ED = E @ Dinv[:, None]                                      # (M, O, 6, 3)

    # reduced camera system: (6K, 3M) incidence-weighted blocks, row
    # k*6 + c, column j*M + m
    P2 = torch.einsum("mok,mocj->kcjm", ob.onehot, ED).reshape(K * 6, 3 * M)
    Q2 = torch.einsum("mok,mocj->kcjm", ob.onehot, E).reshape(K * 6, 3 * M)
    S = -(P2 @ Q2.T)
    b_S = b_c.reshape(K * 6) - P2 @ b_l.T.reshape(3 * M)
    ar = torch.arange(K, device=S.device)
    S = S.reshape(K, 6, K, 6)
    S[ar, :, ar, :] = S[ar, :, ar, :] + H_cc
    dc = _schur_solve(S.reshape(K * 6, K * 6), b_S, prob.opt_mask, lam)

    # landmarks: dl = -D^-1 (b_l + sum_o E^T dc_k)
    dc_obs = torch.einsum("mok,kc->moc", ob.onehot, dc)         # (M, O, 6)
    Et_dc = (E.transpose(-1, -2) @ dc_obs[..., None])[..., 0].sum(1)
    dl = -(Dinv @ (b_l + Et_dc)[..., None])[..., 0]
    dl = torch.where(prob.point_valid[:, None], dl, torch.zeros_like(dl))
    return dc, dl


def _apply(poses, points, dc, dl):
    return geo.se3_exp(dc) @ poses, points + dl


def optimize_ba(cam: Camera, prob: BAProblem, iters: int = 15,
                outlier_rounds: int = 1, fix_points: bool = False) -> BAResult:
    """Run the reference's local/global BA schedule (single device)."""
    ob = _prepare(prob)
    valid0 = prob.obs_valid & (prob.obs_kf >= 0) & prob.point_valid[:, None]

    def lm_phase(poses, points, valid, use_huber, n):
        cost, _ = _cost(cam, poses, points, ob, valid, use_huber)
        lam = torch.tensor(1e-4, dtype=poses.dtype, device=poses.device)
        for _ in range(n):
            dc, dl = _build_and_solve(cam, poses, points, prob, ob, valid,
                                      use_huber, lam)
            if fix_points:
                dl = torch.zeros_like(dl)
            poses_n, points_n = _apply(poses, points, dc, dl)
            cost_n, _ = _cost(cam, poses_n, points_n, ob, valid, use_huber)
            accept = cost_n < cost
            poses = torch.where(accept, poses_n, poses)
            points = torch.where(accept, points_n, points)
            lam = torch.where(accept, lam * 0.5, lam * 4.0)
            cost = torch.where(accept, cost_n, cost)
        return poses, points, cost

    def lm_split(poses, points, valid, use_huber, n):
        n_bulk = max(n - TAIL_ITERS, 0)
        if n_bulk:
            poses, points, _ = lm_phase(poses, points, valid, use_huber, n_bulk)
        return lm_phase(poses, points, valid, use_huber, n - n_bulk)

    poses, points, cost = lm_split(prob.poses, prob.points, valid0, True, iters)
    valid = valid0
    th = torch.where(ob.is_stereo, CHI2_STEREO, CHI2_MONO)
    for _ in range(outlier_rounds):
        _, chi2 = _cost(cam, poses, points, ob, valid, False)
        valid = valid0 & (chi2 <= th)
        poses, points, cost = lm_split(poses, points, valid, False,
                                       max(iters // 2, 1))
    _, chi2 = _cost(cam, poses, points, ob, valid, False)
    return BAResult(poses=poses, points=points, obs_inlier=valid0 & (chi2 <= th),
                    cost=cost)
