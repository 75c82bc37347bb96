"""Kernel Z wrapper: EPnP RANSAC with the all-inlier refine.

Replaces ``orbslam2_tpu/ops/pnp.py``: ``pnp_ransac`` (``_epnp_weighted``,
``ops/geometry.py``: ``horn_align``). CUDA source: ``csrc/pnp_ransac.cu``,
two launches (Z1: a block per hypothesis, its EPnP solved in double by one
thread, then its inliers counted by the block; Z2: one block for the
winner, the weighted EPnP over its inliers, the recount and the choice).
Both the kernel and the plain version (``ops/pnp.py``) return the packed
result

    [Tcw (16), n_inliers, ok, inliers (N)]

as one (18 + N,) float32 tensor; ``unpack`` reads it on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from . import build
from ..models.camera import Camera
from ..ops import pnp

NAME = "pnp_ransac"
FUNCTION = "pnp_ransac"  # both its __global__ functions hold this name
SOURCE = "orbslam2_tpu_torch/kernels/csrc/pnp_ransac.cu"
REPLACES = "orbslam2_tpu/ops/pnp.py:192"
launches = 0


def pack(res: pnp.PnPResult) -> torch.Tensor:
    f = torch.float32
    return torch.cat([res.Tcw.reshape(-1).to(f), res.n_inliers.to(f).reshape(1),
                      res.ok.to(f).reshape(1), res.inliers.to(f)])


def unpack(packed: np.ndarray, n: int) -> pnp.PnPResult:
    """The packed result (host array) as a PnPResult of numpy values."""
    p = np.asarray(packed)
    return pnp.PnPResult(Tcw=p[:16].reshape(4, 4).astype(np.float32),
                         n_inliers=int(p[16]), ok=bool(p[17] > 0.5),
                         inliers=p[18:18 + n] > 0.5)


def pnp_ransac_plain(cam: Camera, pts_w, obs_uv, sigma2, valid, samples,
                     min_inliers: int = 10) -> torch.Tensor:
    return pack(pnp.pnp_ransac(cam, pts_w, obs_uv, sigma2, valid, samples,
                               min_inliers))


def pnp_ransac(cam: Camera, pts_w, obs_uv, sigma2, valid, samples,
               min_inliers: int = 10) -> torch.Tensor:
    """Kernel Z on CUDA tensors, the plain version on CPU tensors: the
    samples' (I, 4) int32 hypotheses over the (N, 3) points, (N, 2) pixels,
    (N,) sigma^2 and validity; returns the packed result."""
    if pts_w.device.type == "cpu":
        return pnp_ransac_plain(cam, pts_w, obs_uv, sigma2, valid, samples,
                                min_inliers)
    dev = pts_w.device
    N, I = pts_w.shape[0], samples.shape[0]
    if N < 1 or I < 1:
        raise ValueError(f"{NAME}: N={N}, I={I} must be positive")
    build.expect(NAME, dev, (
        ("pts_w", pts_w, torch.float32, (N, 3)),
        ("obs_uv", obs_uv, torch.float32, (N, 2)),
        ("sigma2", sigma2, torch.float32, (N,)),
        ("valid", valid, torch.bool, (N,)),
        ("samples", samples, torch.int32, (I, pnp.SAMPLE_SIZE))))
    hyp = torch.empty((I, 16), dtype=torch.float32, device=dev)
    counts = torch.empty(I, dtype=torch.int32, device=dev)
    alpha = torch.empty((N, 4), dtype=torch.float64, device=dev)
    w_best = torch.empty(N, dtype=torch.uint8, device=dev)
    out = torch.empty(18 + N, dtype=torch.float32, device=dev)
    err = build.library().osl_pnp_ransac(
        pts_w.data_ptr(), obs_uv.data_ptr(), sigma2.data_ptr(), valid.data_ptr(),
        N, samples.data_ptr(), I, cam.fx, cam.fy, cam.cx, cam.cy,
        int(min_inliers), hyp.data_ptr(), counts.data_ptr(), alpha.data_ptr(),
        w_best.data_ptr(), out.data_ptr(), build.stream_handle(dev))
    build.check(err, NAME)
    build.count_launch(__name__)
    return out
