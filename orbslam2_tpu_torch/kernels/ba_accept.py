"""Kernel H wrapper: the Levenberg-Marquardt accept / reject step of bundle
adjustment, on the device.

Replaces the tail of the LM body in ``orbslam2_tpu/ops/ba.py``:
``optimize_ba_impl`` (``accept = cost_n < prev_cost`` and the ``jnp.where``
updates). CUDA source: ``csrc/ba.cu`` (``ba_accept_kernel``: one block).

In place: if cost_n < cost, poses <- poses_n, points <- points_n,
cost <- cost_n and lam *= 0.5; otherwise lam *= 4. A NaN cost_n rejects.
"""

from __future__ import annotations

import torch

from . import build
from .ba_linearize import check_sizes

NAME = "ba_accept"
FUNCTION = "ba_accept_kernel"  # the __global__ function it launches
SOURCE = "orbslam2_tpu_torch/kernels/csrc/ba.cu"
REPLACES = "orbslam2_tpu/ops/ba.py:436"
launches = 0


def ba_accept_plain(cost_n, poses_n, points_n, cost, lam, poses, points):
    accept = cost_n < cost
    poses.copy_(torch.where(accept, poses_n, poses))
    points.copy_(torch.where(accept, points_n, points))
    lam.copy_(torch.where(accept, lam * 0.5, lam * 4.0))
    cost.copy_(torch.where(accept, cost_n, cost))


def ba_accept(cost_n, poses_n, points_n, cost, lam, poses, points):
    """Kernel H on CUDA tensors, the plain version on CPU tensors; updates
    cost, lam, poses and points in place."""
    if cost.device.type == "cpu":
        return ba_accept_plain(cost_n, poses_n, points_n, cost, lam, poses, points)
    dev = cost.device
    K, M = poses.shape[0], points.shape[0]
    check_sizes(NAME, K, M, 0)
    build.expect(NAME, dev, (
        ("cost_n", cost_n, torch.float32, (1,)),
        ("poses_n", poses_n, torch.float32, (K, 4, 4)),
        ("points_n", points_n, torch.float32, (M, 3)),
        ("cost", cost, torch.float32, (1,)),
        ("lam", lam, torch.float32, (1,)),
        ("poses", poses, torch.float32, (K, 4, 4)),
        ("points", points, torch.float32, (M, 3))))
    err = build.library().osl_ba_accept(
        cost_n.data_ptr(), poses_n.data_ptr(), points_n.data_ptr(),
        cost.data_ptr(), lam.data_ptr(), poses.data_ptr(), points.data_ptr(),
        K, M, build.stream_handle(dev))
    build.check(err, NAME)
    build.count_launch(__name__)
