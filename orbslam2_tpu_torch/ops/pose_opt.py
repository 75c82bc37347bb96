"""Motion-only bundle adjustment on one SE(3) pose (port of
``orbslam2_tpu.ops.pose_opt``).

The whole schedule (4 rounds x 10 LM iterations, Huber then inliers-only)
runs in kernel D on the card; ``kernels/pose_lm.py`` holds the wrapper and
its plain PyTorch twin.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels import pose_lm as _pose_lm
from ..models.camera import Camera

CHI2_MONO = _pose_lm.CHI2_MONO
CHI2_STEREO = _pose_lm.CHI2_STEREO


class PoseOptResult(NamedTuple):
    Tcw: torch.Tensor        # (4, 4) optimized pose
    inliers: torch.Tensor    # (N,) bool final inlier classification
    n_inliers: torch.Tensor  # () int32
    chi2: torch.Tensor       # (N,) final per-edge chi2


def optimize_pose(Tcw_init: torch.Tensor, cam: Camera, pts_w: torch.Tensor,
                  obs: torch.Tensor, sigma2: torch.Tensor, valid: torch.Tensor,
                  rounds: int = 4, iters: int = 10) -> PoseOptResult:
    """Optimize one camera pose against fixed world points.

    pts_w (N, 3) matched map points; obs (N, 3) observed (u, v, u_right)
    with u_right < 0 marking mono edges; sigma2 (N,) octave variance;
    valid (N,) edge mask.
    """
    return PoseOptResult(*_pose_lm.pose_lm(Tcw_init, cam, pts_w, obs, sigma2,
                                           valid, rounds, iters))
