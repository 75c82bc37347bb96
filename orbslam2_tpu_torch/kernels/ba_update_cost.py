"""Kernel G wrapper: landmark back-substitution and the robust cost of
bundle adjustment, with the chi2 classification of every observation.

Replaces ``orbslam2_tpu/ops/ba.py``: ``_cost_t`` / ``_robust_t`` and the
back-substitution at the end of ``_build_and_solve``. CUDA source:
``csrc/ba.cu`` (``ba_update_cost_kernel``: eight lanes per landmark; each
block writes a partial cost, and the last block to finish sums the
partials in block order, so the cost is the same from run to run).

With a step (dc, E, Dinv, b_l), each valid landmark moves by
dl = -D^-1 (b_l + sum_o E_o^T dc_k(o)) and the cost is taken at the moved
points; without one, at the given points. ``poses`` are the poses to
evaluate (the trial poses of kernel F in an LM step). Returns the points,
the robust cost over the masked observations, and ``inlier``: the
observations of ``obs_valid`` (with a camera, on a valid landmark) whose
chi2 is within the mono / stereo threshold.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import build
from .ba_linearize import check_sizes, chi2_rho, effective_mask, project
from ..models.camera import Camera

NAME = "ba_update_cost"
FUNCTION = "ba_update_cost_kernel"  # the __global__ function it launches
SOURCE = "orbslam2_tpu_torch/kernels/csrc/ba.cu"
REPLACES = "orbslam2_tpu/ops/ba.py:215"
launches = 0

LANDMARKS_PER_BLOCK = 16   # kLandmarksPerBlock in csrc/ba.cu


def _moved_points(points, point_valid, obs_kf, step):
    dc, E, Dinv, b_l = step
    k = obs_kf.long()
    dc_obs = torch.where((k >= 0)[..., None], dc[k.clamp_min(0)],
                         torch.zeros((), dtype=dc.dtype, device=dc.device))
    Et_dc = (E.transpose(-1, -2) @ dc_obs[..., None])[..., 0].sum(1)
    dl = -(Dinv @ (b_l + Et_dc)[..., None])[..., 0]
    return points + torch.where(point_valid[:, None], dl, torch.zeros_like(dl))


def ba_update_cost_plain(cam: Camera, poses, points, point_valid, obs_kf,
                         obs_uvr, obs_sigma2, obs_valid, obs_mask,
                         use_huber: bool, step: Optional[tuple] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if step is not None:
        points = _moved_points(points, point_valid, obs_kf, step)
    r, _, _, _ = project(cam, poses, points, obs_kf, obs_uvr, with_jac=False)
    chi2, rho, delta2 = chi2_rho(r, obs_sigma2, obs_uvr, use_huber)
    mask = effective_mask(obs_kf, obs_mask, point_valid)
    cost = torch.where(mask, rho, torch.zeros_like(rho)).sum().reshape(1)
    inlier = effective_mask(obs_kf, obs_valid, point_valid) & (chi2 <= delta2)
    return points, cost, inlier


def ba_update_cost(cam: Camera, poses, points, point_valid, obs_kf, obs_uvr,
                   obs_sigma2, obs_valid, obs_mask, use_huber: bool,
                   step: Optional[tuple] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel G on CUDA tensors, the plain version on CPU tensors. Without
    a step the returned points are ``points`` itself."""
    if points.device.type == "cpu":
        return ba_update_cost_plain(cam, poses, points, point_valid, obs_kf,
                                    obs_uvr, obs_sigma2, obs_valid, obs_mask,
                                    use_huber, step)
    dev = points.device
    K = poses.shape[0]
    M, O = obs_kf.shape
    check_sizes(NAME, K, M, O)
    specs = [("poses", poses, torch.float32, (K, 4, 4)),
             ("points", points, torch.float32, (M, 3)),
             ("point_valid", point_valid, torch.bool, (M,)),
             ("obs_kf", obs_kf, torch.int32, (M, O)),
             ("obs_uvr", obs_uvr, torch.float32, (M, O, 3)),
             ("obs_sigma2", obs_sigma2, torch.float32, (M, O)),
             ("obs_valid", obs_valid, torch.bool, (M, O)),
             ("obs_mask", obs_mask, torch.bool, (M, O))]
    if step is not None:
        specs += [("dc", step[0], torch.float32, (K, 6)),
                  ("E", step[1], torch.float32, (M, O, 6, 3)),
                  ("Dinv", step[2], torch.float32, (M, 3, 3)),
                  ("b_l", step[3], torch.float32, (M, 3))]
    build.expect(NAME, dev, specs)
    points_n = points if step is None else torch.empty_like(points)
    cost = torch.empty(1, dtype=torch.float32, device=dev)
    inlier = torch.empty((M, O), dtype=torch.bool, device=dev)
    # one partial cost per block, and the blocks' completion counter
    n_blocks = -(-M // LANDMARKS_PER_BLOCK)
    scratch = torch.empty(n_blocks + 1, dtype=torch.float32, device=dev)
    step_ptrs = (None,) * 4 if step is None else tuple(t.data_ptr() for t in step)
    err = build.library().osl_ba_update_cost(
        poses.data_ptr(), points.data_ptr(), point_valid.data_ptr(),
        obs_kf.data_ptr(), obs_uvr.data_ptr(), obs_sigma2.data_ptr(),
        obs_valid.data_ptr(), obs_mask.data_ptr(), *step_ptrs, K, M, O,
        cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, int(use_huber),
        points_n.data_ptr(), cost.data_ptr(), inlier.data_ptr(),
        scratch.data_ptr(), build.stream_handle(dev))
    build.check(err, NAME)
    build.count_launch(__name__)
    return points_n, cost, inlier
