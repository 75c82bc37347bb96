"""Kernel D wrapper: motion-only Levenberg-Marquardt on one SE(3) pose.

Replaces ``orbslam2_tpu/ops/pose_opt.py``: ``optimize_pose``. CUDA source:
``csrc/pose_lm.cu`` (one thread block runs all rounds x iterations in one
launch; on the H100 the eager form is bound by ~1600 dependent small
launches per call, the kernel by its per-iteration block reductions).

Schedule (the reference's): mono/stereo reprojection edges with 3x6
Jacobians for a left twist update, Huber weights with delta^2 = 5.991 /
7.815 in chi2 units, ``rounds`` x ``iters`` LM iterations, chi2
reclassification after each round, the robust kernel dropped and outliers
excluded from round 2 on, lambda starting at 1e-3 per round with x0.5 on
accept and x4 on reject.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import build
from ..ops import geometry as geo
from ..ops import linalg_small

NAME = "pose_lm"
FUNCTION = "pose_lm_kernel"  # the __global__ function it launches
SOURCE = "orbslam2_tpu_torch/kernels/csrc/pose_lm.cu"
REPLACES = "orbslam2_tpu/ops/pose_opt.py:83"
launches = 0

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def residuals_jacobians(T, cam, pts, obs, is_stereo, with_jac=True):
    """Residuals (n, 3), Jacobians (n, 3, 6) and clamped depth (n,) of the
    edges under pose T, with the u_right row zeroed for mono edges. The
    camera-frame point is written out per component, as the kernel
    computes it."""
    R, t = T[:3, :3], T[:3, 3]
    pc = [R[i, 0] * pts[:, 0] + R[i, 1] * pts[:, 1] + R[i, 2] * pts[:, 2] + t[i]
          for i in range(3)]
    x, y, zr = pc
    z = zr.clamp_min(1e-6)
    inv_z = 1.0 / z
    inv_z2 = inv_z * inv_z
    u = cam.fx * x * inv_z + cam.cx
    v = cam.fy * y * inv_z + cam.cy
    ur = u - cam.bf * inv_z
    zero = torch.zeros_like(x)
    r = torch.stack([u - obs[:, 0], v - obs[:, 1],
                     torch.where(is_stereo, ur - obs[:, 2], zero)], dim=1)
    if not with_jac:
        return r, None, z
    jp = [
        [cam.fx * inv_z, zero, -cam.fx * x * inv_z2],
        [zero, cam.fy * inv_z, -cam.fy * y * inv_z2],
        [torch.where(is_stereo, cam.fx * inv_z, zero), zero,
         torch.where(is_stereo, -cam.fx * x * inv_z2 + cam.bf * inv_z2, zero)],
    ]
    J = torch.stack([
        torch.stack([j[0], j[1], j[2],
                     j[1] * (-zr) + j[2] * y,
                     j[0] * zr + j[2] * (-x),
                     j[0] * (-y) + j[1] * x], dim=1)
        for j in jp], dim=1)                                    # (n, 3, 6)
    return r, J, z


def pose_lm_plain(Tcw_init, cam, pts_w, obs, sigma2, valid, rounds=4, iters=10
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(Tcw, inliers (N,) bool, n_inliers () int32, chi2 (N,)). Edges
    outside ``valid`` add exact zeros in the reference, so the LM runs on
    the valid edges only."""
    sel = valid.nonzero()[:, 0]
    P, O, S2 = pts_w[sel], obs[sel], sigma2[sel]
    st = O[:, 2] >= 0
    chi2_th = torch.where(st, CHI2_STEREO, CHI2_MONO)
    inv_s2 = 1.0 / S2.clamp_min(1e-12)

    def edge_chi2(T, pts, ob, stereo, inv_sigma2):
        r, _, z = residuals_jacobians(T, cam, pts, ob, stereo, with_jac=False)
        chi2 = (r * r).sum(1) * inv_sigma2
        return torch.where(z <= 1e-5, torch.full_like(chi2, 1e9), chi2)

    def rho(chi2, use_huber):
        c = chi2.clamp_max(1e9)
        if use_huber:
            return torch.where(c <= chi2_th, c,
                               2.0 * torch.sqrt(chi2_th * c.clamp_min(1e-12)) - chi2_th)
        return c.clamp_max(1e6)

    T = Tcw_init.clone()
    inl = torch.ones_like(st)
    for rnd in range(rounds):
        use_huber = rnd < 2
        mask = torch.ones_like(st) if rnd < 2 else inl
        lam = torch.tensor(1e-3, dtype=T.dtype, device=T.device)
        cost = torch.where(mask, rho(edge_chi2(T, P, O, st, inv_s2), use_huber),
                           0.0).sum()
        for _ in range(iters):
            r, J, _ = residuals_jacobians(T, cam, P, O, st)
            chi2 = (r * r).sum(1) * inv_s2
            w_h = torch.where(chi2 <= chi2_th, 1.0,
                              torch.sqrt(chi2_th / chi2.clamp_min(1e-12)))
            w = (w_h if use_huber else torch.ones_like(w_h)) * inv_s2
            w = torch.where(mask, w, 0.0)
            Jw = J * w[:, None, None]
            H = torch.einsum("nri,nrj->ij", Jw, J)
            b = torch.einsum("nri,nr->i", Jw, r)
            eye = torch.eye(6, dtype=H.dtype, device=H.device)
            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * eye
            dx = -linalg_small.solve_spd_small(Hd, b)
            T_new = geo.se3_exp(dx) @ T
            r2, _, _ = residuals_jacobians(T_new, cam, P, O, st, with_jac=False)
            chi2_new = (r2 * r2).sum(1) * inv_s2
            cost_new = torch.where(mask, rho(chi2_new, use_huber), 0.0).sum()
            accept = cost_new < cost
            T = torch.where(accept, T_new, T)
            lam = torch.where(accept, lam * 0.5, lam * 4.0)
            cost = torch.where(accept, cost_new, cost)
        inl = edge_chi2(T, P, O, st, inv_s2) <= chi2_th

    st_all = obs[:, 2] >= 0
    chi2 = edge_chi2(T, pts_w, obs, st_all, 1.0 / sigma2.clamp_min(1e-12))
    inliers = valid & (chi2 <= torch.where(st_all, CHI2_STEREO, CHI2_MONO))
    return T, inliers, inliers.sum().to(torch.int32), chi2


def pose_lm(Tcw_init, cam, pts_w, obs, sigma2, valid, rounds=4, iters=10
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel D on CUDA tensors, the plain version on CPU tensors."""
    global launches
    if pts_w.device.type == "cpu":
        return pose_lm_plain(Tcw_init, cam, pts_w, obs, sigma2, valid,
                             rounds, iters)
    dev = pts_w.device
    N = pts_w.shape[0]
    for name, t, dtype, shape in (
            ("Tcw_init", Tcw_init, torch.float32, (4, 4)),
            ("pts_w", pts_w, torch.float32, (N, 3)),
            ("obs", obs, torch.float32, (N, 3)),
            ("sigma2", sigma2, torch.float32, (N,)),
            ("valid", valid, torch.bool, (N,))):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{NAME}: {name} must be {dtype} {shape} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if rounds < 1:
        raise ValueError(f"{NAME}: rounds must be >= 1")
    T0, P, O, S2, V = (t.contiguous() for t in (Tcw_init, pts_w, obs, sigma2, valid))
    T_out = torch.empty((4, 4), dtype=torch.float32, device=dev)
    inliers = torch.empty(N, dtype=torch.bool, device=dev)
    n_inl = torch.empty((), dtype=torch.int32, device=dev)
    chi2 = torch.empty(N, dtype=torch.float32, device=dev)
    err = build.library().osl_pose_lm(
        T0.data_ptr(), P.data_ptr(), O.data_ptr(), S2.data_ptr(), V.data_ptr(),
        N, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, int(rounds), int(iters),
        T_out.data_ptr(), inliers.data_ptr(), n_inl.data_ptr(), chi2.data_ptr(),
        build.stream_handle(dev))
    build.check(err, NAME)
    launches += 1
    return T_out, inliers, n_inl, chi2
