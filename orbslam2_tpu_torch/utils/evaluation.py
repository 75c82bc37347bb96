"""Trajectory evaluation: ATE / RPE, equivalent to the TUM benchmark scripts.

The reference relies on the external evaluate_ate.py / KITTI devkit
(SURVEY §4.2); we implement the metrics in-repo so accuracy is checkable in
CI: Horn alignment (with optional scale for monocular) + RMSE of
translational error, and relative pose error over a fixed delta.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def associate_trajectories(
    t_est: np.ndarray, t_gt: np.ndarray, max_dt: float = 0.02
) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy nearest-timestamp association (like TUM associate.py)."""
    i = j = 0
    pairs = []
    while i < len(t_est) and j < len(t_gt):
        dt = t_est[i] - t_gt[j]
        if abs(dt) <= max_dt:
            pairs.append((i, j))
            i += 1
            j += 1
        elif dt > 0:
            j += 1
        else:
            i += 1
    if not pairs:
        return np.zeros(0, int), np.zeros(0, int)
    a, b = zip(*pairs)
    return np.asarray(a), np.asarray(b)


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


def load_tum_groundtruth(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """TUM groundtruth.txt -> (timestamps (N,), positions (N, 3))."""
    ts, xyz = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            p = line.split()
            ts.append(float(p[0]))
            xyz.append([float(p[1]), float(p[2]), float(p[3])])
    return np.asarray(ts), np.asarray(xyz)


def load_kitti_poses(path: str) -> np.ndarray:
    """KITTI poses/SS.txt (3x4 row-major per line) -> (N, 4, 4) Twc."""
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    out = np.tile(np.eye(4), (len(rows), 1, 1))
    out[:, :3, :] = rows
    return out


def load_euroc_groundtruth(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """EuRoC state_groundtruth_estimate0/data.csv -> (ts_s (N,), pos (N,3))."""
    ts, xyz = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            p = line.split(",")
            ts.append(float(p[0]) * 1e-9)
            xyz.append([float(p[1]), float(p[2]), float(p[3])])
    return np.asarray(ts), np.asarray(xyz)


def load_tum_trajectory(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """TUM-format trajectory file -> (timestamps, positions)."""
    return load_tum_groundtruth(path)


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
