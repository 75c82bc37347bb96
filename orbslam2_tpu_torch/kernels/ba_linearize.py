"""Kernel E wrapper: one LM linearisation of bundle adjustment, reduced to
the camera system.

Replaces ``orbslam2_tpu/ops/ba.py``: ``_project_t`` and the normal-equation
and Schur-complement half of ``_build_and_solve``. CUDA source:
``csrc/ba.cu``, a memset and three launches: ``ba_linearize_kernel``
(eight lanes per landmark, one per observation slot) writes each
observation's blocks and raises its camera's bounds on them;
``ba_linearize_pairs_kernel`` (lane o1 of a landmark, over every o2) adds
each pair's terms into 64-bit fixed point below its camera block's bound
(integer atomics); ``ba_linearize_sum_kernel`` writes S and b_S. No float
atomics: S is the same from run to run, each term within 2^-41 of its
block's bound.

Per observation: residual r, Jacobians Jp (3x6, left twist, clamped depth)
and Jl (3x3), and the weight w (Huber or 1, over sigma^2; 0 outside the
mask or at depth <= 1e-5). Per landmark: D = sum Jl^T w Jl, b_l, and the
adjugate inverse of D + damp I. Per camera pair the reduced system

    S   = blockdiag(sum Jp^T w Jp) - sum_m sum_{o1,o2} E_o1 D^-1 E_o2^T
    b_S = sum Jp^T w r - sum_m E_o D^-1 b_l

with E_o = Jp^T w Jl. The plain version forms the pair sums as one matrix
product of the landmarks' blocks placed in their cameras' rows and
scatters the diagonal blocks with ``index_add_``.

Limits of the kernels E-H and F': K <= 256 cameras, M <= 32768 landmarks,
O <= 8 observation slots (the reference's largest global-BA bucket,
``orbslam2_tpu/loop_closing.py:594``); larger problems raise.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from . import build
from ..models.camera import Camera

NAME = "ba_linearize"
FUNCTION = "ba_linearize"  # its __global__ functions ba_linearize{,_pairs,_sum}_kernel
LAUNCHES_PER_CALL = 3
SOURCE = "orbslam2_tpu_torch/kernels/csrc/ba.cu"
REPLACES = "orbslam2_tpu/ops/ba.py:243"
launches = 0

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
MAX_K, MAX_M, MAX_O = 256, 32768, 8


class Linearized(NamedTuple):
    S: torch.Tensor      # (6K, 6K) reduced camera system, row k*6 + c
    b_S: torch.Tensor    # (6K,)
    E: torch.Tensor      # (M, O, 6, 3) Jp^T w Jl
    Dinv: torch.Tensor   # (M, 3, 3) damped landmark block inverse
    b_l: torch.Tensor    # (M, 3) Jl^T w r summed over the observations


def check_sizes(name: str, K: int, M: int, O: int):
    if K > MAX_K or M > MAX_M or O > MAX_O:
        raise ValueError(f"{name}: the kernel takes K <= {MAX_K} cameras, "
                         f"M <= {MAX_M} landmarks and O <= {MAX_O} slots; got "
                         f"K={K}, M={M}, O={O}")


def effective_mask(obs_kf, obs_mask, point_valid):
    """The observations that count: in the mask, with a camera, on a valid
    landmark."""
    return obs_mask & (obs_kf >= 0) & point_valid[:, None]


def project(cam: Camera, poses, points, obs_kf, obs_uvr, with_jac=True):
    """Residuals r (M, O, 3), Jacobians Jp (M, O, 3, 6) for a left twist on
    the observing camera and Jl (M, O, 3, 3) for the point, clamped depth
    z (M, O). Slots without a camera read camera 0."""
    T = poses[obs_kf.long().clamp_min(0)]                       # (M, O, 4, 4)
    R = T[..., :3, :3]
    pc = (R @ points[:, None, :, None])[..., 0] + T[..., :3, 3]  # (M, O, 3)
    x, y = pc[..., 0], pc[..., 1]
    z = pc[..., 2].clamp_min(1e-6)
    inv_z = 1.0 / z
    inv_z2 = inv_z * inv_z
    u = cam.fx * x * inv_z + cam.cx
    v = cam.fy * y * inv_z + cam.cy
    st = obs_uvr[..., 2] >= 0
    zero = torch.zeros_like(z)
    r = torch.stack([u - obs_uvr[..., 0], v - obs_uvr[..., 1],
                     torch.where(st, (u - cam.bf * inv_z) - obs_uvr[..., 2], zero)],
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
    # d(pc)/d(xi) = [I | -hat(pc)] with the clamped depth (left twist)
    one = torch.ones_like(z)
    Jpose = torch.stack([
        torch.stack([one, zero, zero, zero, z, -y], -1),
        torch.stack([zero, one, zero, -z, zero, x], -1),
        torch.stack([zero, zero, one, y, -x, zero], -1),
    ], -2)                                                      # (M, O, 3, 6)
    return r, Jpix @ Jpose, Jpix @ R, z


def chi2_rho(r, obs_sigma2, obs_uvr, use_huber: bool):
    """chi2 (M, O), the per-observation robust cost and the Huber
    threshold delta^2."""
    s2 = obs_sigma2.clamp_min(1e-12)
    chi2 = (r * r).sum(-1) / s2
    delta2 = torch.where(obs_uvr[..., 2] >= 0, CHI2_STEREO, CHI2_MONO)
    if use_huber:
        rho = torch.where(chi2 <= delta2, chi2,
                          2.0 * torch.sqrt(delta2 * chi2.clamp_min(1e-12)) - delta2)
    else:
        rho = chi2.clamp_max(1e6)
    return chi2, rho, delta2


def damped_inv3(D, lam, point_valid):
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


def ba_linearize_plain(cam: Camera, poses, points, point_valid, obs_kf, obs_uvr,
                       obs_sigma2, obs_mask, lam, use_huber: bool,
                       out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                       ) -> Linearized:
    """With ``out`` (S, b_S) the system is also written there and returned
    as those tensors."""
    K = poses.shape[0]
    M, O = obs_kf.shape
    valid = effective_mask(obs_kf, obs_mask, point_valid)
    r, Jp, Jl, z = project(cam, poses, points, obs_kf, obs_uvr)
    chi2, _, delta2 = chi2_rho(r, obs_sigma2, obs_uvr, use_huber)
    one = torch.ones_like(chi2)
    w_h = torch.where(chi2 <= delta2, one,
                      torch.sqrt(delta2 / chi2.clamp_min(1e-12)))
    w = (w_h if use_huber else one) / obs_sigma2.clamp_min(1e-12)
    w = torch.where(valid & (z > 1e-5), w, torch.zeros_like(w))
    Jpw_t = (Jp * w[..., None, None]).transpose(-1, -2)         # (M, O, 6, 3)
    Jlw_t = (Jl * w[..., None, None]).transpose(-1, -2)         # (M, O, 3, 3)
    r_c = r[..., None]
    D = (Jlw_t @ Jl).sum(1)                                     # (M, 3, 3)
    b_l = (Jlw_t @ r_c)[..., 0].sum(1)                          # (M, 3)
    E = Jpw_t @ Jl                                              # (M, O, 6, 3)
    Dinv = damped_inv3(D, lam, point_valid)
    ED = E @ Dinv[:, None]                                      # (M, O, 6, 3)

    # camera blocks: each ordered pair of a landmark's observations adds
    # -E_o1 D^-1 E_o2^T at (k(o1), k(o2)), each observation Jp^T w Jp on
    # the diagonal; slots without a camera add exact zeros to camera 0. The
    # pairs are one product: each landmark's E D^-1 and E placed in their
    # cameras' rows, (6K, 3M) x (3M, 6K)
    k = obs_kf.long().clamp_min(0)
    rows = torch.arange(M, device=k.device)[:, None].expand(M, O)
    by_cam = []
    for blk in (ED, E):
        z = torch.zeros((M, K, 6, 3), dtype=poses.dtype, device=poses.device)
        z.index_put_((rows, k), blk, accumulate=True)
        by_cam.append(z.permute(1, 2, 0, 3).reshape(6 * K, 3 * M))
    S = -(by_cam[0] @ by_cam[1].T)
    diag = torch.zeros((K, 6, 6), dtype=poses.dtype, device=poses.device)
    diag.index_add_(0, k.reshape(-1), (Jpw_t @ Jp).reshape(-1, 6, 6))
    cams = torch.arange(K, device=k.device)
    S.view(K, 6, K, 6)[cams, :, cams, :] += diag
    b_o = (Jpw_t @ r_c)[..., 0] - (ED @ b_l[:, None, :, None])[..., 0]
    b_S = torch.zeros((K, 6), dtype=poses.dtype, device=poses.device)
    b_S.index_add_(0, k.reshape(-1), b_o.reshape(-1, 6))
    b_S = b_S.reshape(6 * K)
    if out is not None:
        S, b_S = out[0].copy_(S), out[1].copy_(b_S)
    return Linearized(S, b_S, E, Dinv, b_l)


def ba_linearize(cam: Camera, poses, points, point_valid, obs_kf, obs_uvr,
                 obs_sigma2, obs_mask, lam, use_huber: bool,
                 out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                 ) -> Linearized:
    """Kernel E on CUDA tensors, the plain version on CPU tensors. ``lam``
    is a (1,) tensor on the device, read by the kernel. ``out``: (S (6K,
    6K), b_S (6K,)) tensors the system is written into (a shard's row of a
    packed buffer)."""
    if points.device.type == "cpu":
        return ba_linearize_plain(cam, poses, points, point_valid, obs_kf,
                                  obs_uvr, obs_sigma2, obs_mask, lam, use_huber,
                                  out=out)
    dev = points.device
    K = poses.shape[0]
    M, O = obs_kf.shape
    check_sizes(NAME, K, M, O)
    build.expect(NAME, dev, (
        ("poses", poses, torch.float32, (K, 4, 4)),
        ("points", points, torch.float32, (M, 3)),
        ("point_valid", point_valid, torch.bool, (M,)),
        ("obs_kf", obs_kf, torch.int32, (M, O)),
        ("obs_uvr", obs_uvr, torch.float32, (M, O, 3)),
        ("obs_sigma2", obs_sigma2, torch.float32, (M, O)),
        ("obs_mask", obs_mask, torch.bool, (M, O)),
        ("lam", lam, torch.float32, (1,))))
    f32 = dict(dtype=torch.float32, device=dev)
    if out is None:
        out = (torch.empty((6 * K, 6 * K), **f32), torch.empty(6 * K, **f32))
    build.expect(NAME, dev, (("S", out[0], torch.float32, (6 * K, 6 * K)),
                             ("b_S", out[1], torch.float32, (6 * K,))))
    res = Linearized(out[0], out[1], torch.empty((M, O, 6, 3), **f32),
                     torch.empty((M, 3, 3), **f32), torch.empty((M, 3), **f32))
    lib = build.library()
    work = torch.empty(lib.osl_ba_linearize_work_bytes(K, M, O),
                       dtype=torch.uint8, device=dev)
    err = lib.osl_ba_linearize(
        poses.data_ptr(), points.data_ptr(), point_valid.data_ptr(),
        obs_kf.data_ptr(), obs_uvr.data_ptr(), obs_sigma2.data_ptr(),
        obs_mask.data_ptr(), lam.data_ptr(), K, M, O, cam.fx, cam.fy, cam.cx,
        cam.cy, cam.bf, int(use_huber), work.data_ptr(),
        *(t.data_ptr() for t in res), build.stream_handle(dev))
    build.check(err, NAME)
    build.count_launch(__name__)
    return res
