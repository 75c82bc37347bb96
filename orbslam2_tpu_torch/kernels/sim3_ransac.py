"""Kernel K wrapper: Sim3 RANSAC between the matched map points of the
loop's two keyframes.

Replaces ``orbslam2_tpu/ops/sim3_solver.py``: ``sim3_ransac`` (256
three-point Horn hypotheses, the both-way chi2 inlier count, argmax, the
weighted refit). CUDA source: ``csrc/sim3_ransac.cu``, two launches (a block
per hypothesis: Horn in double by one thread, its inliers counted by the
block; then one block for the winner, the refit with fixed-order sums, the
recount and the choice). Both the kernel and the plain version
(``ops/sim3_solver.py``) return the packed result

    [S12 (8), n_inliers, ok, inliers (N)]

as one (10 + N,) float32 tensor; ``unpack`` reads it on the host. Horn's
eigenvector comes from a Jacobi solve in double on the card and from
``torch.linalg.eigh`` in the plain version, so hypotheses agree to float
rounding and the inlier counts near the gate may differ by a point.
"""

from __future__ import annotations

import numpy as np
import torch

from . import build
from ..models.camera import Camera
from ..ops import sim3_solver

NAME = "sim3_ransac"
FUNCTION = "sim3_ransac"  # both its __global__ functions hold this name
SOURCE = "orbslam2_tpu_torch/kernels/csrc/sim3_ransac.cu"
REPLACES = "orbslam2_tpu/ops/sim3_solver.py:32"
launches = 0


def pack(res: sim3_solver.Sim3Result) -> torch.Tensor:
    f = torch.float32
    return torch.cat([res.S12.to(f), res.n_inliers.to(f).reshape(1),
                      res.ok.to(f).reshape(1), res.inliers.to(f)])


def unpack(packed: np.ndarray, n: int) -> sim3_solver.Sim3Result:
    """The packed result (host array) as a Sim3Result of numpy values."""
    p = np.asarray(packed)
    return sim3_solver.Sim3Result(S12=p[:8].astype(np.float32),
                                  n_inliers=int(p[8]), ok=bool(p[9] > 0.5),
                                  inliers=p[10:10 + n] > 0.5)


def sim3_ransac_plain(cam: Camera, pts1_c, pts2_c, sigma2_1, sigma2_2, valid,
                      samples, fix_scale: bool = False,
                      min_inliers: int = 20) -> torch.Tensor:
    return pack(sim3_solver.sim3_ransac(cam, pts1_c, pts2_c, sigma2_1, sigma2_2,
                                        valid, samples, fix_scale, min_inliers))


def sim3_ransac(cam: Camera, pts1_c, pts2_c, sigma2_1, sigma2_2, valid, samples,
                fix_scale: bool = False, min_inliers: int = 20) -> torch.Tensor:
    """Kernel K on CUDA tensors, the plain version on CPU tensors: the (I, 3)
    int32 samples over the (N, 3) points of each camera, their (N,)
    sigma^2 and validity; returns the packed result."""
    if pts1_c.device.type == "cpu":
        return sim3_ransac_plain(cam, pts1_c, pts2_c, sigma2_1, sigma2_2, valid,
                                 samples, fix_scale, min_inliers)
    dev = pts1_c.device
    N, I = pts1_c.shape[0], samples.shape[0]
    if N < 1 or I < 1:
        raise ValueError(f"{NAME}: N={N}, I={I} must be positive")
    build.expect(NAME, dev, (
        ("pts1_c", pts1_c, torch.float32, (N, 3)),
        ("pts2_c", pts2_c, torch.float32, (N, 3)),
        ("sigma2_1", sigma2_1, torch.float32, (N,)),
        ("sigma2_2", sigma2_2, torch.float32, (N,)),
        ("valid", valid, torch.bool, (N,)),
        ("samples", samples, torch.int32, (I, 3))))
    hyps = torch.empty((I, 8), dtype=torch.float32, device=dev)
    counts = torch.empty(I, dtype=torch.int32, device=dev)
    w_best = torch.empty(N, dtype=torch.uint8, device=dev)
    out = torch.empty(10 + N, dtype=torch.float32, device=dev)
    err = build.library().osl_sim3_ransac(
        pts1_c.data_ptr(), pts2_c.data_ptr(), sigma2_1.data_ptr(),
        sigma2_2.data_ptr(), valid.data_ptr(), N, samples.data_ptr(), I, cam.fx,
        cam.fy, cam.cx, cam.cy, int(fix_scale), sim3_solver.TH2,
        int(min_inliers), hyps.data_ptr(), counts.data_ptr(), w_best.data_ptr(),
        out.data_ptr(), build.stream_handle(dev))
    build.check(err, NAME)
    build.count_launch(__name__)
    return out
