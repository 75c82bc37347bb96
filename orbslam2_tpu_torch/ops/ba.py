"""Bundle adjustment: Levenberg-Marquardt with the landmark Schur complement
(port of ``orbslam2_tpu.ops.ba``).

One LM iteration is four steps, each a hand-written CUDA kernel for CUDA
tensors and its plain PyTorch version for CPU tensors
(``orbslam2_tpu_torch/kernels/ba_*.py``):

  E ``ba_linearize``    residuals, Jacobians, robust weights; per landmark
                        D^-1; the reduced camera system
                        S = blockdiag(H_cc) - sum_m E_m D_m^-1 E_m^T (6K x 6K)
  F ``ba_solve``        fixed cameras, damping, Cholesky solve, trial poses
  G ``ba_update_cost``  landmark back-substitution and the trial cost (also
                        the phase's initial cost and the chi2 classification)
  H ``ba_accept``       cost test, lambda x0.5 / x4, keep or revert

All state (poses, points, lambda, cost) stays on the device; nothing in
``optimize_ba`` waits for the device.

Schedule (the reference's): ``iters`` Huber iterations, then per outlier
round a chi2 classification and ``iters // 2`` iterations on the inliers
without the robust kernel. Each phase restarts lambda at 1e-4 and is split
into a bulk part and a 3-iteration tail, as the reference's mixed-precision
schedule is; here both parts run in float32.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..kernels import ba_accept, ba_linearize, ba_solve, ba_update_cost
from ..models.camera import Camera

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


class _Steps(NamedTuple):
    linearize: Callable
    solve: Callable
    update_cost: Callable
    accept: Callable


KERNEL_STEPS = _Steps(ba_linearize.ba_linearize, ba_solve.ba_solve,
                      ba_update_cost.ba_update_cost, ba_accept.ba_accept)
PLAIN_STEPS = _Steps(ba_linearize.ba_linearize_plain, ba_solve.ba_solve_plain,
                     ba_update_cost.ba_update_cost_plain,
                     ba_accept.ba_accept_plain)


def pad_problem(prob: BAProblem, K: int, M: int) -> BAProblem:
    """``prob`` padded to K cameras and M landmarks the way the reference
    pads global BA to its size buckets: identity poses, held fixed; points
    at the origin, invalid, without observations. Neither changes the
    solution."""
    k, m = prob.poses.shape[0], prob.points.shape[0]

    def pad(t, n, fill):
        extra = torch.full((n - t.shape[0],) + tuple(t.shape[1:]), fill,
                           dtype=t.dtype, device=t.device)
        return torch.cat([t, extra])

    eye = torch.eye(4, dtype=prob.poses.dtype, device=prob.poses.device)
    return BAProblem(
        poses=torch.cat([prob.poses, eye.expand(K - k, 4, 4)]),
        opt_mask=pad(prob.opt_mask, K, False), points=pad(prob.points, M, 0.0),
        point_valid=pad(prob.point_valid, M, False),
        obs_kf=pad(prob.obs_kf, M, -1), obs_uvr=pad(prob.obs_uvr, M, -1.0),
        obs_sigma2=pad(prob.obs_sigma2, M, 1.0),
        obs_valid=pad(prob.obs_valid, M, False))


def optimize_ba(cam: Camera, prob: BAProblem, iters: int = 15,
                outlier_rounds: int = 1, fix_points: bool = False) -> BAResult:
    """Run the reference's local/global BA schedule (single device): the
    kernels for CUDA tensors, their plain versions for CPU tensors."""
    return _schedule(cam, prob, iters, outlier_rounds, fix_points, KERNEL_STEPS)


def optimize_ba_plain(cam: Camera, prob: BAProblem, iters: int = 15,
                      outlier_rounds: int = 1, fix_points: bool = False
                      ) -> BAResult:
    """The same schedule in plain PyTorch on any device (the kernels'
    yardstick on the card)."""
    return _schedule(cam, prob, iters, outlier_rounds, fix_points, PLAIN_STEPS)


def _split(n: int):
    """A phase of n iterations as its bulk part and its tail."""
    n_bulk = max(n - TAIL_ITERS, 0)
    return ([n_bulk] if n_bulk else []) + [n - n_bulk]


def _schedule(cam, prob: BAProblem, iters, outlier_rounds, fix_points,
              steps: _Steps) -> BAResult:
    obs = (prob.point_valid, prob.obs_kf, prob.obs_uvr, prob.obs_sigma2)
    lengths = _split(iters) + outlier_rounds * _split(max(iters // 2, 1))
    # one lambda per phase, each starting at 1e-4
    lams = torch.full((len(lengths),), 1e-4, dtype=prob.poses.dtype,
                      device=prob.poses.device)
    poses = prob.poses.clone()
    points = prob.points.clone()
    phase = iter(range(len(lengths)))

    def lm_phase(mask, use_huber, n):
        p = next(phase)
        lam = lams[p:p + 1]
        _, cost, _ = steps.update_cost(cam, poses, points, *obs,
                                       prob.obs_valid, mask, use_huber)
        for _ in range(n):
            lin = steps.linearize(cam, poses, points, *obs, mask, lam, use_huber)
            dc, poses_n = steps.solve(lin.S, lin.b_S, prob.opt_mask, lam, poses)
            # fix_points: dl = 0, so the trial points are the points
            step = None if fix_points else (dc, lin.E, lin.Dinv, lin.b_l)
            points_n, cost_n, _ = steps.update_cost(
                cam, poses_n, points, *obs, prob.obs_valid, mask, use_huber, step)
            steps.accept(cost_n, poses_n, points_n, cost, lam, poses, points)
        return cost

    mask = prob.obs_valid
    for n in _split(iters):
        cost = lm_phase(mask, True, n)
    for _ in range(outlier_rounds):
        _, _, mask = steps.update_cost(cam, poses, points, *obs,
                                       prob.obs_valid, mask, False)
        for n in _split(max(iters // 2, 1)):
            cost = lm_phase(mask, False, n)
    _, _, inlier = steps.update_cost(cam, poses, points, *obs, prob.obs_valid,
                                     mask, False)
    return BAResult(poses=poses, points=points, obs_inlier=inlier,
                    cost=cost.reshape(()))
