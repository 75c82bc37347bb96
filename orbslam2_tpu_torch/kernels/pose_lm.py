"""Kernel D wrapper: motion-only Levenberg-Marquardt on one SE(3) pose.

Replaces ``orbslam2_tpu/ops/pose_opt.py``: ``optimize_pose``. CUDA source:
``csrc/pose_lm.cu`` (one thread block runs all rounds x iterations in one
launch; on the H100 the eager form is bound by its hundreds of dependent
small launches per call, the kernel by its per-iteration block
reductions).

The plain version keeps the linearisation of a rejected step (the pose did
not move) and solves the 6x6 system with the operations of
``linalg_small.solve_spd_small`` on host float32 scalars; both give the
same bits as the step-by-step tensor form at a fraction of its operations.

Schedule (the reference's): mono/stereo reprojection edges with 3x6
Jacobians for a left twist update, Huber weights with delta^2 = 5.991 /
7.815 in chi2 units, ``rounds`` x ``iters`` LM iterations, chi2
reclassification after each round, the robust kernel dropped and outliers
excluded from round 2 on, lambda starting at 1e-3 per round with x0.5 on
accept and x4 on reject.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import build
from ..ops import geometry as geo

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
    pc = R[:, 0] * pts[:, 0:1] + R[:, 1] * pts[:, 1:2] + R[:, 2] * pts[:, 2:3] + t
    x, y, zr = pc.unbind(1)
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
    j02 = -cam.fx * x * inv_z2
    jp = torch.stack([
        torch.stack([cam.fx * inv_z, zero, j02], dim=1),
        torch.stack([zero, cam.fy * inv_z, -cam.fy * y * inv_z2], dim=1),
        torch.stack([torch.where(is_stereo, cam.fx * inv_z, zero), zero,
                     torch.where(is_stereo, j02 + cam.bf * inv_z2, zero)], dim=1),
    ], dim=1)                                                   # (n, 3, 3)
    j0, j1, j2 = jp[..., 0:1], jp[..., 1:2], jp[..., 2:3]
    J = torch.cat([jp, j1 * (-zr)[:, None, None] + j2 * y[:, None, None],
                   j0 * zr[:, None, None] + j2 * (-x)[:, None, None],
                   j0 * (-y)[:, None, None] + j1 * x[:, None, None]], dim=2)
    return r, J, z                                              # (n, 3, 6)


def _solve6_host(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``linalg_small.solve_spd_small`` of one system: the same float32
    operations in the same order, on host scalars (the square roots by
    torch)."""
    A, b, dev = A.cpu().numpy(), b.cpu().numpy(), A.device
    n = A.shape[0]
    eps, one = np.float32(1e-12), np.float32(1.0)
    L = [[None] * n for _ in range(n)]
    with np.errstate(all="ignore"):
        for j in range(n):
            s = A[j, j]
            for k in range(j):
                s = s - L[j][k] * L[j][k]
            # torch's sqrt, which rounds unlike numpy's in the last bit
            L[j][j] = torch.sqrt(torch.from_numpy(np.maximum(s, eps)[None]))[0].numpy()
            inv = one / L[j][j]
            for i in range(j + 1, n):
                s = A[i, j]
                for k in range(j):
                    s = s - L[i][k] * L[j][k]
                L[i][j] = s * inv
        y = [None] * n
        for i in range(n):
            s = b[i]
            for k in range(i):
                s = s - L[i][k] * y[k]
            y[i] = s / L[i][i]
        x = [None] * n
        for i in reversed(range(n)):
            s = y[i]
            for k in range(i + 1, n):
                s = s - L[k][i] * x[k]
            x[i] = s / L[i][i]
    return torch.from_numpy(np.array(x, np.float32)).to(dev)


def _outputs(N, dev, out):
    """(Tcw, inliers, n_inliers, chi2) buffers; ``out`` = (Tcw, n_inliers)
    to write the pose and count into."""
    T_out, n_inl = out if out is not None else (
        torch.empty((4, 4), dtype=torch.float32, device=dev),
        torch.empty((), dtype=torch.int32, device=dev))
    return (T_out, torch.empty(N, dtype=torch.bool, device=dev), n_inl,
            torch.empty(N, dtype=torch.float32, device=dev))


def pose_lm_plain(Tcw_init, cam, pts_w, obs, sigma2, valid, rounds=4, iters=10,
                  gate=None, out=None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(Tcw, inliers (N,) bool, n_inliers () int32, chi2 (N,)). Edges
    outside ``valid`` add exact zeros in the reference unless their point
    is NaN, so the LM runs on the valid edges only (a NaN point on an
    invalid edge freezes the reference's LM, not this one: ROADMAP queue
    3). ``gate`` and ``out`` as for ``pose_lm``."""
    if not build.gate_open(gate):
        return _outputs(pts_w.shape[0], pts_w.device, out)
    T, inliers, n_inl, chi2 = _pose_lm_plain(Tcw_init, cam, pts_w, obs, sigma2,
                                             valid, rounds, iters)
    if out is not None:
        out[0].copy_(T)
        out[1].copy_(n_inl)
        T, n_inl = out
    return T, inliers, n_inl, chi2


def _pose_lm_plain(Tcw_init, cam, pts_w, obs, sigma2, valid, rounds, iters):
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
    eye = torch.eye(6, dtype=T.dtype, device=T.device)
    for rnd in range(rounds):
        use_huber = rnd < 2
        mask = torch.ones_like(st) if rnd < 2 else inl
        lam = torch.tensor(1e-3, dtype=T.dtype, device=T.device)
        cost = torch.where(mask, rho(edge_chi2(T, P, O, st, inv_s2), use_huber),
                           0.0).sum()
        system = None  # (H, b) at T, kept while steps are rejected
        for _ in range(iters):
            if system is None:
                r, J, _ = residuals_jacobians(T, cam, P, O, st)
                chi2 = (r * r).sum(1) * inv_s2
                w_h = torch.where(chi2 <= chi2_th, 1.0,
                                  torch.sqrt(chi2_th / chi2.clamp_min(1e-12)))
                w = (w_h if use_huber else torch.ones_like(w_h)) * inv_s2
                w = torch.where(mask, w, 0.0)
                Jw = J * w[:, None, None]
                system = (torch.einsum("nri,nrj->ij", Jw, J),
                          torch.einsum("nri,nr->i", Jw, r))
            H, b = system
            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * eye
            dx = -_solve6_host(Hd, b)
            T_new = geo.se3_exp(dx) @ T
            r2, _, _ = residuals_jacobians(T_new, cam, P, O, st, with_jac=False)
            chi2_new = (r2 * r2).sum(1) * inv_s2
            cost_new = torch.where(mask, rho(chi2_new, use_huber), 0.0).sum()
            if bool(cost_new < cost):
                T, cost, lam, system = T_new, cost_new, lam * 0.5, None
            else:
                lam = lam * 4.0
        inl = edge_chi2(T, P, O, st, inv_s2) <= chi2_th

    st_all = obs[:, 2] >= 0
    chi2 = edge_chi2(T, pts_w, obs, st_all, 1.0 / sigma2.clamp_min(1e-12))
    inliers = valid & (chi2 <= torch.where(st_all, CHI2_STEREO, CHI2_MONO))
    return T, inliers, inliers.sum().to(torch.int32), chi2


def pose_lm(Tcw_init, cam, pts_w, obs, sigma2, valid, rounds=4, iters=10,
            gate=None, out=None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel D on CUDA tensors, the plain version on CPU tensors. With a
    ``gate`` (count, threshold) it runs only while the device count is below
    the threshold; ``out`` = ((4, 4) pose, () int32 count) receives the
    result, and may hold the gate's own count (the cascade's retry writes
    over the first pass)."""
    if pts_w.device.type == "cpu":
        return pose_lm_plain(Tcw_init, cam, pts_w, obs, sigma2, valid,
                             rounds, iters, gate, out)
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
    if out is not None:
        build.expect(NAME, dev, (("out Tcw", out[0], torch.float32, (4, 4)),
                                 ("out n_inliers", out[1], torch.int32, ())))
    T0, P, O, S2, V = (t.contiguous() for t in (Tcw_init, pts_w, obs, sigma2, valid))
    T_out, inliers, n_inl, chi2 = _outputs(N, dev, out)
    gate_n, gate_min = build.gate_args(gate)
    err = build.library().osl_pose_lm(
        T0.data_ptr(), P.data_ptr(), O.data_ptr(), S2.data_ptr(), V.data_ptr(),
        N, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, int(rounds), int(iters),
        gate_n, gate_min, T_out.data_ptr(), inliers.data_ptr(), n_inl.data_ptr(),
        chi2.data_ptr(), build.stream_handle(dev))
    build.check(err, NAME)
    build.count_launch(__name__)
    return T_out, inliers, n_inl, chi2
