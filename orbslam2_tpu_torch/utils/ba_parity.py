"""How closely two bundle-adjustment results agree, and how far the kernels'
results spread on the card.

    python -m orbslam2_tpu_torch.utils.ba_parity [--seeds 16] [--reps 4]

``compare`` holds a result (the kernels', or a sharded schedule's) against
a reference (the plain schedule) on one problem. The two sum S and the
costs in other orders, so they round differently, and a landmark that its
observations barely pin down (a short baseline, few inliers) moves along
its weak direction by far more than that rounding. Points are therefore
read two ways:

- ``points``: the largest difference relative to the point's distance, over
  the landmarks that the reference's final inliers constrain: the point's
  largest standard deviation at 1 px of noise at level 0 (from the smallest
  eigenvalue of D = sum Jl^T w Jl, w = 1/sigma^2) is at most ``LOOSE_SD`` of
  its distance. ``points_all`` is the same over every landmark, and
  ``loose`` counts the landmarks left out;
- ``reproj``: over every landmark, sqrt(dl^T D dl), the pixels (at level 0,
  root of the weighted squares over its inlier observations) by which the
  difference dl moves the point's reprojections.

Run as a script on a CUDA device, it solves ``ba_window`` problems of
``--seeds`` seeds (and the seed chip_smoke.py uses) at the two shapes that
chip_smoke.py checks, the plain schedule once and the kernels ``--reps``
times per seed, and prints each kernel run against the plain result, the
kernels' run-to-run spread (each run against the seed's first; zero since
kernel E sums S in a fixed order), and the
largest reading of each per shape beside its limit.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from ..kernels import ba_linearize
from ..models.camera import Camera
from ..ops import ba
from .synthetic import ba_window

LOOSE_SD = 0.05
# kernels (or shards) against the plain schedule: sums in another order
# (readings and margins in PERF.md)
LIMITS = dict(poses=1e-4, points=1e-4, reproj=1e-2, flips=1e-3, cost=1e-3)
# chip_smoke.py's shapes: cameras, landmarks, iterations (+ one outlier
# round): the local-BA window, the reference bench's, and the largest
# global-BA bucket (kernel F' solves it)
SHAPES = ((16, 1024, 5), (64, 4096, 10), (256, 32768, 10))


def compare(cam: Camera, prob: ba.BAProblem, res: ba.BAResult,
            ref: ba.BAResult) -> dict:
    """Readings of ``res`` against ``ref``, two results of ``prob``."""
    _, _, Jl, z = ba_linearize.project(cam, ref.poses, ref.points, prob.obs_kf,
                                       prob.obs_uvr)
    inl = ba_linearize.effective_mask(prob.obs_kf, ref.obs_inlier,
                                      prob.point_valid) & (z > 1e-5)
    w = inl / prob.obs_sigma2.clamp_min(1e-12)
    D = torch.einsum("moki,mo,mokj->mij", Jl, w, Jl).double().cpu()
    d = (res.points - ref.points).double().cpu()
    dist = ref.points.double().cpu().norm(dim=1).clamp_min(1e-6)
    sd = torch.linalg.eigvalsh(D)[:, 0].clamp_min(1e-30).rsqrt()
    tight = sd <= LOOSE_SD * dist
    rel = d.norm(dim=1) / dist
    reproj = torch.einsum("mi,mij,mj->m", d, D, d).clamp_min(0).sqrt()
    return dict(
        poses=(res.poses - ref.poses).abs().max().item(),
        points=rel[tight].max().item() if bool(tight.any()) else 0.0,
        points_all=rel.max().item(), loose=int((~tight).sum()),
        reproj=reproj.max().item(),
        flips=(res.obs_inlier != ref.obs_inlier).float().mean().item(),
        cost=abs(res.cost.item() - ref.cost.item()) / abs(ref.cost.item()))


def over_limits(readings: dict) -> dict:
    """The readings above their ``LIMITS``."""
    return {k: readings[k] for k, lim in LIMITS.items() if readings[k] > lim}


def _fmt(r: dict) -> str:
    return " ".join(f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in r.items())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=16)
    ap.add_argument("--reps", type=int, default=4)
    args = ap.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    dev = torch.device("cuda")
    cam = Camera.create(520.0, 520.0, 320.0, 240.0, bf=52.0, width=640, height=480)
    for K, M, iters in SHAPES:
        worst, spread = {}, {}
        for seed in [K] + list(range(args.seeds)):
            prob = ba.BAProblem(*(torch.from_numpy(a).to(dev)
                                  for a in ba_window(K, M, 8, seed=seed)))
            rp = ba.optimize_ba_plain(cam, prob, iters=iters, outlier_rounds=1)
            runs = [ba.optimize_ba(cam, prob, iters=iters, outlier_rounds=1)
                    for _ in range(args.reps)]
            for i, rk in enumerate(runs):
                r = compare(cam, prob, rk, rp)
                s = compare(cam, prob, rk, runs[0])
                print(f"K={K} M={M} seed {seed} run {i}: vs plain {_fmt(r)} | "
                      f"vs run 0 {_fmt(s)}")
                for acc, new in ((worst, r), (spread, s)):
                    for k, v in new.items():
                        acc[k] = max(acc.get(k, v), v)
        print(f"K={K} M={M} O=8 iters={iters}+outlier round, "
              f"{args.seeds + 1} seeds x {args.reps} runs: largest vs plain "
              f"{_fmt(worst)}; largest run-to-run {_fmt(spread)}; limits "
              f"{_fmt(LIMITS)}")


if __name__ == "__main__":
    main()
