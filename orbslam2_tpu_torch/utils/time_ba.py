"""The bundle-adjustment schedule's time on the card, to compare trees.

    python -m orbslam2_tpu_torch.utils.time_ba [--reps 20]

Solves chip_smoke.py's BA problems (``utils/ba_parity.SHAPES``: the local
window K=16/M=1024, the reference bench's K=64/M=4096 and the largest
global-BA bucket K=256/M=32768, O=8, ``ba_window`` at seed K) with
``ops.ba.optimize_ba`` and one outlier round, ``--reps`` times each
between CUDA events, and prints one JSON line: the card's name and power
limit and, per shape, the median ms a solve, the final cost, and kernel
E's ms a call over ``--reps`` back-to-back calls at the problem's start
(``e_ms``: the device's time where it is longer than the host's). Each
solve waits for the one before (its wrapper work on the host counts, as it
does in the local mapper). To compare two trees, copy this file into the other
tree's package and run both from their roots in one call, alternating.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

from ..kernels import ba_linearize
from ..models.camera import Camera
from ..ops import ba
from .synthetic import ba_window

SHAPES = ((16, 1024, 5), (64, 4096, 10), (256, 32768, 10))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    dev = torch.device("cuda")
    cam = Camera.create(520.0, 520.0, 320.0, 240.0, bf=52.0, width=640, height=480)
    out = dict(card=card)
    for K, M, iters in SHAPES:
        prob = ba.BAProblem(*(torch.from_numpy(a).to(dev)
                              for a in ba_window(K, M, 8, seed=K)))

        def solve():
            return ba.optimize_ba(cam, prob, iters=iters, outlier_rounds=1)

        for _ in range(3):
            solve()
        torch.cuda.synchronize()
        times = []
        for _ in range(args.reps):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            res = solve()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        lam = torch.full((1,), 1e-4, device=dev)
        e_args = (cam, prob.poses, prob.points, prob.point_valid, prob.obs_kf,
                  prob.obs_uvr, prob.obs_sigma2, prob.obs_valid, lam, True)
        ba_linearize.ba_linearize(*e_args)
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(args.reps):
            ba_linearize.ba_linearize(*e_args)
        b.record()
        b.synchronize()
        out[f"K={K} M={M} iters={iters}"] = dict(
            ms=statistics.median(times), cost=float(res.cost),
            e_ms=a.elapsed_time(b) / args.reps)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
