"""Host-side (numpy) Sim3 algebra, batched (the port's own copy of
``orbslam2_tpu.ops.sim3_np``).

Loop closing's bookkeeping (the corrected group's poses and points, the
essential graph's edge measurements and write-back) operates on handfuls of
4x4 poses and (..., 8) Sim3 vectors that live in host memory between device
solves, so it runs here in numpy; ``ops/geometry.py`` has the torch versions
the solvers use. The packing is the same: (..., 8) = [s, q_wxyz, t].
"""

from __future__ import annotations

import numpy as np

_EPS = 1e-9


def quat_to_rotmat(q: np.ndarray) -> np.ndarray:
    q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), _EPS)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.empty(q.shape[:-1] + (3, 3), q.dtype)
    R[..., 0, 0] = 1 - 2 * (y * y + z * z)
    R[..., 0, 1] = 2 * (x * y - w * z)
    R[..., 0, 2] = 2 * (x * z + w * y)
    R[..., 1, 0] = 2 * (x * y + w * z)
    R[..., 1, 1] = 1 - 2 * (x * x + z * z)
    R[..., 1, 2] = 2 * (y * z - w * x)
    R[..., 2, 0] = 2 * (x * z - w * y)
    R[..., 2, 1] = 2 * (y * z + w * x)
    R[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    """Shepperd 4-case select, batched (same math as geometry.rotmat_to_quat)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    qw0 = np.sqrt(np.maximum(1.0 + tr, _EPS)) * 0.5
    c0 = np.stack(
        [qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
         (m10 - m01) / (4 * qw0)], axis=-1)
    qx1 = np.sqrt(np.maximum(1.0 + m00 - m11 - m22, _EPS)) * 0.5
    c1 = np.stack(
        [(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1),
         (m02 + m20) / (4 * qx1)], axis=-1)
    qy2 = np.sqrt(np.maximum(1.0 - m00 + m11 - m22, _EPS)) * 0.5
    c2 = np.stack(
        [(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2,
         (m12 + m21) / (4 * qy2)], axis=-1)
    qz3 = np.sqrt(np.maximum(1.0 - m00 - m11 + m22, _EPS)) * 0.5
    c3 = np.stack(
        [(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3),
         (m12 + m21) / (4 * qz3), qz3], axis=-1)

    diag = np.stack([tr, m00, m11, m22], axis=-1)
    case = np.argmax(diag, axis=-1)
    cands = np.stack([c0, c1, c2, c3], axis=-2)  # (..., 4, 4)
    q = np.take_along_axis(cands, case[..., None, None].repeat(4, -1), -2)
    q = q[..., 0, :]
    q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), _EPS)
    # canonical sign: w >= 0
    return np.where(q[..., :1] < 0, -q, q)


def make(s, R: np.ndarray, t: np.ndarray) -> np.ndarray:
    q = rotmat_to_quat(R)
    s = np.broadcast_to(np.asarray(s, R.dtype), R.shape[:-2])
    return np.concatenate([s[..., None], q, t], axis=-1)


def s_of(S: np.ndarray) -> np.ndarray:
    return S[..., 0]


def R_of(S: np.ndarray) -> np.ndarray:
    return quat_to_rotmat(S[..., 1:5])


def t_of(S: np.ndarray) -> np.ndarray:
    return S[..., 5:8]


def apply(S: np.ndarray, p: np.ndarray) -> np.ndarray:
    """x -> s R x + t, broadcasting (..., 8) against (..., 3)."""
    return (
        s_of(S)[..., None] * np.einsum("...ij,...j->...i", R_of(S), p)
        + t_of(S)
    )


def compose(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """A ∘ B (apply B first)."""
    sA, RA, tA = s_of(A), R_of(A), t_of(A)
    sB, RB, tB = s_of(B), R_of(B), t_of(B)
    t = sA[..., None] * np.einsum("...ij,...j->...i", RA, tB) + tA
    return make(sA * sB, RA @ RB, t)


def inverse(S: np.ndarray) -> np.ndarray:
    s, R, t = s_of(S), R_of(S), t_of(S)
    s_inv = 1.0 / np.maximum(s, _EPS)
    Rt = np.swapaxes(R, -1, -2)
    t_inv = -s_inv[..., None] * np.einsum("...ij,...j->...i", Rt, t)
    return make(s_inv, Rt, t_inv)


def from_se3(T: np.ndarray, s=1.0) -> np.ndarray:
    return make(s, np.ascontiguousarray(T[..., :3, :3]), T[..., :3, 3])


def to_se3(S: np.ndarray) -> np.ndarray:
    """[R t/s; 0 1] — the loop-correction write-back projection."""
    s, R, t = s_of(S), R_of(S), t_of(S)
    out = np.zeros(S.shape[:-1] + (4, 4), S.dtype)
    out[..., :3, :3] = R
    out[..., :3, 3] = t / np.maximum(s, _EPS)[..., None]
    out[..., 3, 3] = 1.0
    return out
