"""Batched SO(3)/SE(3) geometry, quaternions and DLT triangulation (port of
``orbslam2_tpu.ops.geometry``; Sim(3) and Horn alignment come with loop
closing).

Conventions as the reference: ``Tcw`` is the 4x4 camera-from-world
transform, quaternions are (w, x, y, z), se3 tangents are (rho, phi)
translation-first. All functions broadcast over leading batch dimensions.
"""

from __future__ import annotations

import math

import torch

from . import linalg_small

_EPS = 1e-8


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------

def hat(phi: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of (..., 3) -> (..., 3, 3)."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def vee(M: torch.Tensor) -> torch.Tensor:
    return torch.stack([M[..., 2, 1], M[..., 0, 2], M[..., 1, 0]], dim=-1)


def _exp_coeffs(phi: torch.Tensor):
    """theta2 and the Rodrigues / left-Jacobian coefficients a, b, c with
    the reference's small-angle Taylor branches."""
    theta2 = (phi * phi).sum(-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(
        small, 1.0 / 6.0 - theta2 / 120.0,
        (theta - torch.sin(theta)) / (theta2 * theta),
    )
    return a, b, c


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    a, b, _ = _exp_coeffs(phi)
    K = hat(phi)
    eye = _eye3(phi).expand(K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    _, b, c = _exp_coeffs(phi)
    K = hat(phi)
    eye = _eye3(phi).expand(K.shape)
    return eye + b[..., None, None] * K + c[..., None, None] * (K @ K)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation -> (..., 3) axis-angle, stable near 0 and pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = ((trace - 1.0) * 0.5).clamp(-1.0, 1.0)
    w_generic = vee(R - R.transpose(-1, -2))
    sin2 = 0.25 * (w_generic * w_generic).sum(-1)
    small = cos_t > 1.0 - 1e-5
    cos_safe = torch.where(small, torch.zeros_like(cos_t), cos_t).clamp(
        -1.0 + 1e-7, 1.0)
    theta = torch.where(small, torch.sqrt(sin2 + _EPS * _EPS),
                        torch.arccos(cos_safe))
    sin_t = torch.sin(theta)
    scale = torch.where(small, 0.5 + sin2 / 12.0,
                        theta / (2.0 * sin_t.clamp_min(_EPS)))
    w = w_generic * scale[..., None]
    near_pi = cos_t < -1.0 + 1e-4
    RpI = R + _eye3(R).expand(R.shape)
    col_norms = (RpI * RpI).sum(-2)
    best = col_norms.argmax(-1)
    axis = torch.gather(
        RpI, -1, best[..., None, None].expand(RpI.shape[:-1] + (1,)))[..., 0]
    axis = axis / torch.linalg.norm(axis, dim=-1, keepdim=True).clamp_min(_EPS)
    sin_small = (0.5 * torch.linalg.norm(w_generic, dim=-1)).clamp(0.0, 1.0)
    theta_pi = math.pi - torch.arcsin(sin_small)
    dot = (axis * w_generic).sum(-1)
    axis = axis * torch.where(dot < 0, -1.0, 1.0)[..., None]
    w_pi = axis * theta_pi[..., None]
    return torch.where(near_pi[..., None], w_pi, w)


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------

def se3_from_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    T = torch.zeros(batch + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form rigid inverse (valid while R is orthonormal)."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    t = T[..., :3, 3]
    return se3_from_rt(Rt, -(Rt @ t[..., None])[..., 0])


def se3_orthonormalize(T: torch.Tensor) -> torch.Tensor:
    """Project the rotation block back onto SO(3) (Gram-Schmidt + cross)."""
    R = T[..., :3, :3]
    r0 = R[..., :, 0]
    r0 = r0 / torch.linalg.norm(r0, dim=-1, keepdim=True).clamp_min(1e-12)
    r1 = R[..., :, 1]
    r1 = r1 - (r1 * r0).sum(-1, keepdim=True) * r0
    r1 = r1 / torch.linalg.norm(r1, dim=-1, keepdim=True).clamp_min(1e-12)
    r2 = torch.linalg.cross(r0, r1, dim=-1)
    return se3_from_rt(torch.stack([r0, r1, r2], dim=-1), T[..., :3, 3])


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6) twist (rho, phi) -> (..., 4, 4)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    V = so3_left_jacobian(phi)
    t = (V @ rho[..., None])[..., 0]
    return se3_from_rt(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    phi = so3_log(T[..., :3, :3])
    V = so3_left_jacobian(phi)
    rho = torch.linalg.solve(V, T[..., :3, 3:4])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to (..., N, 3) points."""
    return pts @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def apply_se3(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return (T[..., :3, :3] @ p[..., None])[..., 0] + T[..., :3, 3]


# ---------------------------------------------------------------------------
# Quaternions (w, x, y, z)
# ---------------------------------------------------------------------------

def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(_EPS)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Shepperd's method, choosing the best-conditioned of four cases."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw0 = torch.sqrt((1.0 + tr).clamp_min(_EPS)) * 0.5
    c0 = torch.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                      (m10 - m01) / (4 * qw0)], dim=-1)
    qx1 = torch.sqrt((1.0 + m00 - m11 - m22).clamp_min(_EPS)) * 0.5
    c1 = torch.stack([(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1),
                      (m02 + m20) / (4 * qx1)], dim=-1)
    qy2 = torch.sqrt((1.0 - m00 + m11 - m22).clamp_min(_EPS)) * 0.5
    c2 = torch.stack([(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2,
                      (m12 + m21) / (4 * qy2)], dim=-1)
    qz3 = torch.sqrt((1.0 - m00 - m11 + m22).clamp_min(_EPS)) * 0.5
    c3 = torch.stack([(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3),
                      (m12 + m21) / (4 * qz3), qz3], dim=-1)
    scores = torch.stack([tr, m00 - m11 - m22, -m00 + m11 - m22,
                          -m00 - m11 + m22], dim=-1)
    idx = scores.argmax(-1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)
    q = torch.gather(cands, -2, idx[..., None, None].expand(
        idx.shape + (1, 4)))[..., 0, :]
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(_EPS)


# ---------------------------------------------------------------------------
# Two-view triangulation (batched DLT)
# ---------------------------------------------------------------------------

def triangulate_dlt(P1: torch.Tensor, P2: torch.Tensor, x1: torch.Tensor,
                    x2: torch.Tensor) -> torch.Tensor:
    """Linear triangulation: (..., 3, 4) projections, (..., N, 2) pixels ->
    (..., N, 3) points. The smallest eigenvector of the equilibrated 4x4
    Gram matrix by three steps of damped inverse iteration, as the
    reference computes it. The Gram matrix, its trace and the norms are
    written term by term, in kernel S's order (a matrix product or a
    reduction would let the card's libraries contract or reorder them)."""

    def rows(P, x):
        u, v = x[..., 0:1], x[..., 1:2]
        p0 = P[..., None, 0, :]
        p1 = P[..., None, 1, :]
        p2 = P[..., None, 2, :]
        return [u * p2 - p0, v * p2 - p1]                       # (..., N, 4)

    A = rows(P1, x1) + rows(P2, x2)
    G = A[0][..., :, None] * A[0][..., None, :]
    for a in A[1:]:
        G = G + a[..., :, None] * a[..., None, :]                # (..., N, 4, 4)
    diag = torch.diagonal(G, dim1=-2, dim2=-1)
    d = 1.0 / torch.sqrt(diag.clamp_min(1e-12))
    B = G * d[..., None, :] * d[..., :, None]
    tr = B[..., 0, 0] + B[..., 1, 1] + B[..., 2, 2] + B[..., 3, 3]
    eye4 = torch.eye(4, dtype=B.dtype, device=B.device)
    damped = B + (1e-7 * tr + 1e-12)[..., None, None] * eye4
    Y = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=B.dtype,
                     device=B.device).expand(B.shape[:-1])
    for _ in range(3):
        Y = linalg_small.solve_spd_small(damped, Y)
        y = [Y[..., k] for k in range(4)]
        nrm = torch.sqrt(y[0] * y[0] + y[1] * y[1] + y[2] * y[2] + y[3] * y[3])
        Y = Y / nrm.clamp_min(_EPS)[..., None]
    X = Y * d
    w = X[..., 3]
    safe_w = torch.where(w.abs() < _EPS, torch.where(w < 0, -_EPS, _EPS), w)
    return X[..., :3] / safe_w[..., None]
