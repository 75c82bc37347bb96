"""Kernel D's device time on chip_smoke.py's pose problem, to compare trees.

    python -m orbslam2_tpu_torch.utils.time_pose_lm [--reps 30] [--seed 0]

Builds a pose problem of the shape of chip_smoke.py's kernel-D row (12288
edges, 600 valid, 10% gross outliers, half of them stereo, 640x480 at fx
520, a perturbed start) from ``--seed``, and a copy with one valid point
NaN. Each is timed as ``--reps`` batches of 20 back-to-back calls of kernel
D between CUDA events (the queue stays full, so the wrapper's host work is
hidden); prints one JSON line: the card's name and power limit, the median
ms a call of each problem, and the inlier count. To compare two trees, copy
this file into the other tree's package and run both from their roots in
one call, alternating. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import numpy as np
import torch

from ..kernels import pose_lm
from ..models.camera import Camera

W, H, FX, BF = 640, 480, 520.0, 52.0
EDGES, VALID = 12288, 600
BATCH = 20


def problem(seed: int, dev):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-3, 3, EDGES), rng.uniform(-2, 2, EDGES),
                    rng.uniform(2, 8, EDGES)], 1).astype(np.float32)
    pc = pts + np.float32([0.05, -0.02, 0.1])
    u = FX * pc[:, 0] / pc[:, 2] + W / 2 + rng.normal(0, 0.7, EDGES)
    v = FX * pc[:, 1] / pc[:, 2] + H / 2 + rng.normal(0, 0.7, EDGES)
    ur = np.where(np.arange(EDGES) % 2 == 0, u - BF / pc[:, 2], -1.0)
    obs = np.stack([u, v, ur], 1).astype(np.float32)
    out = rng.random(EDGES) < 0.1
    obs[out, :2] += rng.uniform(-40, 40, (int(out.sum()), 2))
    sigma2 = (1.2 ** (2.0 * rng.integers(0, 8, EDGES))).astype(np.float32)
    valid = np.zeros(EDGES, bool)
    valid[rng.choice(EDGES, VALID, replace=False)] = True
    cam = Camera.create(FX, FX, W / 2, H / 2, bf=BF, width=W, height=H)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731
    nan_pts = pts.copy()
    nan_pts[np.where(valid)[0][0]] = np.nan
    return [(t(np.eye(4, dtype=np.float32)), cam, t(p), t(obs), t(sigma2), t(valid))
            for p in (pts, nan_pts)]


def ms_a_call(args, reps: int) -> float:
    for _ in range(3):
        pose_lm.pose_lm(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(BATCH):
            pose_lm.pose_lm(*args)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / BATCH)
    return statistics.median(times)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    clean, poisoned = problem(args.seed, torch.device("cuda"))
    out = dict(card=card, ms=ms_a_call(clean, args.reps),
               ms_nan_point=ms_a_call(poisoned, args.reps),
               inliers=int(pose_lm.pose_lm(*clean)[2]))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
