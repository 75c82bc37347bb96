"""Trajectory evaluation: ATE / RPE, equivalent to the TUM benchmark scripts.

The reference relies on the external evaluate_ate.py / KITTI devkit
(SURVEY §4.2); we implement the metrics in-repo so accuracy is checkable in
CI: Horn alignment (with optional scale for monocular) + RMSE of
translational error, and relative pose error over a fixed delta.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def horn_align_np(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Closed-form s, R, t with dst ~ s R src + t (numpy oracle version)."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    sc = src - mu_s
    dc = dst - mu_d
    H = sc.T @ dc
    U, S, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    D = np.diag([1.0, 1.0, d])
    R = Vt.T @ D @ U.T
    if with_scale:
        s = np.trace(np.diag(S) @ D) / max((sc ** 2).sum() / len(src), 1e-12) / len(src)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(
    traj_est: np.ndarray,
    traj_gt: np.ndarray,
    with_scale: bool = True,
) -> float:
    """Absolute trajectory error RMSE after Horn alignment.

    Args: (N, 3) translation trajectories, already associated.
    `with_scale=True` for monocular (Sim3 alignment), False for stereo/RGB-D
    (SE3), matching the TUM script's --scale handling.
    """
    if len(traj_est) < 3:
        return float("inf")
    s, R, t = horn_align_np(traj_est, traj_gt, with_scale)
    aligned = s * traj_est @ R.T + t
    err = np.linalg.norm(aligned - traj_gt, axis=1)
    return float(np.sqrt((err ** 2).mean()))


def rpe(
    poses_est: np.ndarray, poses_gt: np.ndarray, delta: int = 1
) -> Tuple[float, float]:
    """Relative pose error (trans RMSE [m], rot RMSE [rad]) over `delta`
    frame steps. Poses are (N, 4, 4) world-from-camera (Twc)."""
    n = len(poses_est) - delta
    if n < 1:
        return float("inf"), float("inf")
    dt_err = []
    dr_err = []
    for i in range(n):
        de = np.linalg.inv(poses_est[i]) @ poses_est[i + delta]
        dg = np.linalg.inv(poses_gt[i]) @ poses_gt[i + delta]
        e = np.linalg.inv(dg) @ de
        dt_err.append(np.linalg.norm(e[:3, 3]))
        cos = np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1)
        dr_err.append(np.arccos(cos))
    return (
        float(np.sqrt(np.mean(np.square(dt_err)))),
        float(np.sqrt(np.mean(np.square(dr_err)))),
    )
