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

The same schedule runs over landmark shards (``schedule``), as the
reference's ``optimize_ba_impl`` runs under ``axis_name``: E and G on
every shard, each shard's S, b_S and costs summed by a ``Reduction``
(``parallel/sharded_ba.py`` in one process, ``parallel/distributed.py``
across processes), F once on the summed system, H on every shard. Every
shard ends each iteration with the same poses, lambda and cost, bit for
bit. ``optimize_ba`` is the one-shard case, with nothing to sum.

Schedule (the reference's): ``iters`` Huber iterations, then per outlier
round a chi2 classification and ``iters // 2`` iterations on the inliers
without the robust kernel. Each phase restarts lambda at 1e-4 and is split
into a bulk part and a 3-iteration tail, as the reference's mixed-precision
schedule is; here both parts run in float32.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, NamedTuple, Optional, Protocol, Sequence

import torch

from ..device import on
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


class Reduction(Protocol):
    """How the shards' partial sums are added (the reference's ``psum``).
    ``system_rows(i)`` / ``cost_row(i)``: the tensors shard i's kernel E
    writes its S and b_S into and kernel G its cost into (None: E and G
    allocate their own). ``system(lins)``: S, b_S summed over the shards, on
    the first shard's device. ``cost(costs)``: the summed cost, one tensor
    per shard on its device (each shard's kernel H updates its own)."""

    def system_rows(self, i: int): ...

    def cost_row(self, i: int): ...

    def system(self, lins: Sequence[ba_linearize.Linearized]): ...

    def cost(self, costs: Sequence[torch.Tensor]) -> List[torch.Tensor]: ...


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
    return schedule(cam, [prob], iters, outlier_rounds, fix_points,
                    KERNEL_STEPS)[0]


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
    return schedule(cam, [prob], iters, outlier_rounds, fix_points, steps)[0]


def _made_current(device):
    """A context that makes ``device`` the current CUDA device where it is
    not already (a shard on another card); nothing otherwise."""
    dev = torch.device(device)
    if (dev.type == "cuda" and dev.index is not None
            and dev.index != torch.cuda.current_device()):
        return on(dev)
    return contextlib.nullcontext()


class _Shard:
    """One shard's problem and its copy of the solve's state."""

    def __init__(self, prob: BAProblem, n_phases: int):
        self.prob = prob
        self.on = _made_current(prob.points.device)
        self.obs = (prob.point_valid, prob.obs_kf, prob.obs_uvr, prob.obs_sigma2)
        # one lambda per phase, each starting at 1e-4
        self.lams = torch.full((n_phases,), 1e-4, dtype=prob.poses.dtype,
                               device=prob.poses.device)
        self.poses = prob.poses.clone()
        self.points = prob.points.clone()
        self.mask = prob.obs_valid


def schedule(cam, probs: Sequence[BAProblem], iters, outlier_rounds,
             fix_points, steps: _Steps, reduction: Optional[Reduction] = None
             ) -> List[BAResult]:
    """The schedule over the landmark shards ``probs`` (each the cameras and
    its own landmarks, on its device), their sums added by ``reduction``
    (None for one shard). Each shard's kernels launch with its device current; F solves on
    the first shard's. Returns each shard's result: the same poses and cost
    on every shard, its own points and inliers."""
    if reduction is None and len(probs) != 1:
        raise ValueError("more than one shard needs a reduction")
    lengths = _split(iters) + outlier_rounds * _split(max(iters // 2, 1))
    shards = []
    for p in probs:
        with _made_current(p.points.device):
            shards.append(_Shard(p, len(lengths)))
    first = shards[0]
    phase = iter(range(len(lengths)))
    n = len(shards)
    cost_rows = [reduction and reduction.cost_row(i) for i in range(n)]
    system_rows = [reduction and reduction.system_rows(i) for i in range(n)]

    def summed(costs):
        if reduction is None:
            return costs
        with first.on:
            return reduction.cost(costs)

    def lm_phase(use_huber, n_iters):
        p = next(phase)
        lam = [s.lams[p:p + 1] for s in shards]
        costs = []
        for i, s in enumerate(shards):
            with s.on:
                costs.append(steps.update_cost(
                    cam, s.poses, s.points, *s.obs, s.prob.obs_valid, s.mask,
                    use_huber, cost_out=cost_rows[i])[1])
        costs = summed(costs)
        for _ in range(n_iters):
            lins = []
            for i, s in enumerate(shards):
                with s.on:
                    lins.append(steps.linearize(
                        cam, s.poses, s.points, *s.obs, s.mask, lam[i], use_huber,
                        out=system_rows[i]))
            with first.on:
                S, b_S = ((lins[0].S, lins[0].b_S) if reduction is None
                          else reduction.system(lins))
                dc, poses_n = steps.solve(S, b_S, first.prob.opt_mask, lam[0],
                                          first.poses)
            trials = []
            for i, (s, lin) in enumerate(zip(shards, lins)):
                with s.on:
                    dev = s.poses.device
                    dc_i, poses_i = dc.to(dev), poses_n.to(dev)
                    # fix_points: dl = 0, so the trial points are the points
                    step = None if fix_points else (dc_i, lin.E, lin.Dinv, lin.b_l)
                    points_i, cost_i, _ = steps.update_cost(
                        cam, poses_i, s.points, *s.obs, s.prob.obs_valid, s.mask,
                        use_huber, step, cost_out=cost_rows[i])
                trials.append((poses_i, points_i, cost_i))
            cost_n = summed([t[2] for t in trials])
            for i, (s, (poses_i, points_i, _)) in enumerate(zip(shards, trials)):
                with s.on:
                    steps.accept(cost_n[i], poses_i, points_i, costs[i], lam[i],
                                 s.poses, s.points)
        return costs

    for n_iters in _split(iters):
        costs = lm_phase(True, n_iters)
    for _ in range(outlier_rounds):
        for s in shards:
            with s.on:
                _, _, s.mask = steps.update_cost(cam, s.poses, s.points, *s.obs,
                                                 s.prob.obs_valid, s.mask, False)
        for n_iters in _split(max(iters // 2, 1)):
            costs = lm_phase(False, n_iters)
    out = []
    for s, cost in zip(shards, costs):
        with s.on:
            _, _, inlier = steps.update_cost(cam, s.poses, s.points, *s.obs,
                                             s.prob.obs_valid, s.mask, False)
        out.append(BAResult(poses=s.poses, points=s.points, obs_inlier=inlier,
                            cost=cost.reshape(())))
    return out
