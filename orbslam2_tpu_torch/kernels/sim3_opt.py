"""Kernel M wrapper, its LM launch: Sim3 refinement of the loop transform
(OptimizeSim3).

Replaces ``orbslam2_tpu/ops/sim3_opt.py``: ``optimize_sim3`` (5 + 10 LM
iterations on one Sim3 over paired reprojection edges, Huber sqrt(10), the
chi2 re-gate between). CUDA source: ``csrc/sim3_opt.cu``
(``sim3_opt_lm``: one block runs the whole schedule; the residuals' 4 x 7
Jacobian in dual numbers through the Sim3 algebra, ``csrc/sim3.cuh``, where
the plain version, ``ops/sim3_opt.py``, uses ``torch.func.jacfwd``). Both
return the packed result

    [S12 (8), n_inliers, inliers (N)]

as one (9 + N,) float32 tensor; ``unpack`` reads it on the host.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import build
from ..models.camera import Camera
from ..ops import sim3_opt

NAME = "sim3_opt"
FUNCTION = "sim3_opt_lm"  # the __global__ function it launches
SOURCE = "orbslam2_tpu_torch/kernels/csrc/sim3_opt.cu"
REPLACES = "orbslam2_tpu/ops/sim3_opt.py:57"
launches = 0


def pack(res: sim3_opt.Sim3OptResult) -> torch.Tensor:
    f = torch.float32
    return torch.cat([res.S12.to(f), res.n_inliers.to(f).reshape(1),
                      res.inliers.to(f)])


def unpack(packed: np.ndarray, n: int) -> sim3_opt.Sim3OptResult:
    p = np.asarray(packed)
    return sim3_opt.Sim3OptResult(S12=p[:8].astype(np.float32),
                                  n_inliers=int(p[8]), inliers=p[9:9 + n] > 0.5)


def optimize_sim3_plain(cam: Camera, S12_0, p1c, p2c, u1, u2, sigma2_1,
                        sigma2_2, valid, fix_scale: bool = False,
                        iters2: int = sim3_opt.ITERS2, mid_inliers=None,
                        decide=None) -> torch.Tensor:
    """``mid_inliers`` and ``decide``: as ``ops.sim3_opt.optimize_sim3``'s."""
    return pack(sim3_opt.optimize_sim3(cam, S12_0, p1c, p2c, u1, u2, sigma2_1,
                                       sigma2_2, valid, fix_scale, iters2=iters2,
                                       mid_inliers=mid_inliers, decide=decide))


def optimize_sim3(cam: Camera, S12_0, p1c, p2c, u1, u2, sigma2_1, sigma2_2,
                  valid, fix_scale: bool = False, iters2: int = sim3_opt.ITERS2,
                  costs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel M's LM on CUDA tensors, the plain version on CPU tensors.
    With ``iters2=0`` the result is the first phase's: its S12 and the chi2
    gate's inlier set, which the second phase optimizes over. ``costs``, a
    (ITERS1 + iters2, 2) float32 tensor on the device, receives each LM
    iteration's robust cost at the trial step and at the current S12 (the
    step is taken where the first is the lower)."""
    if p1c.device.type == "cpu":
        return optimize_sim3_plain(cam, S12_0, p1c, p2c, u1, u2, sigma2_1,
                                   sigma2_2, valid, fix_scale, iters2)
    dev = p1c.device
    N = p1c.shape[0]
    build.expect(NAME, dev, (
        ("S12_0", S12_0, torch.float32, (8,)),
        ("p1c", p1c, torch.float32, (N, 3)),
        ("p2c", p2c, torch.float32, (N, 3)),
        ("u1", u1, torch.float32, (N, 2)),
        ("u2", u2, torch.float32, (N, 2)),
        ("sigma2_1", sigma2_1, torch.float32, (N,)),
        ("sigma2_2", sigma2_2, torch.float32, (N,)),
        ("valid", valid, torch.bool, (N,)))
        + ((("costs", costs, torch.float32, (sim3_opt.ITERS1 + iters2, 2)),)
           if costs is not None else ()))
    f32 = dict(dtype=torch.float32, device=dev)
    inv1, inv2 = torch.empty(N, **f32), torch.empty(N, **f32)
    mask = torch.empty(N, dtype=torch.uint8, device=dev)
    out = torch.empty(9 + N, **f32)
    err = build.library().osl_sim3_opt(
        S12_0.data_ptr(), p1c.data_ptr(), p2c.data_ptr(), u1.data_ptr(),
        u2.data_ptr(), sigma2_1.data_ptr(), sigma2_2.data_ptr(), valid.data_ptr(),
        N, cam.fx, cam.fy, cam.cx, cam.cy, int(fix_scale), sim3_opt.TH2,
        sim3_opt.ITERS1, int(iters2), inv1.data_ptr(), inv2.data_ptr(),
        mask.data_ptr(), out.data_ptr(),
        None if costs is None else costs.data_ptr(), build.stream_handle(dev))
    build.check(err, NAME)
    build.count_launch(__name__)
    return out
