"""Kernel L wrapper: RGB-D depth sampling, virtual right coordinate and the
keypoints' undistortion, per keypoint.

Replaces ``orbslam2_tpu/tracking.py:436`` (``_rgbd_virtual_right_u16``) and
``orbslam2_tpu/models/camera.py:84`` (``undistort_points``) as the tracker's
``_make_frame`` calls them. CUDA source: ``csrc/rgbd_depth.cu`` (one thread
per keypoint; launch-bound at ~20 KB). It reads the host-quantised depth map
as uint16, as the reference uploads it. Bit-exact against
``rgbd_depth_plain``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import build
from ..models.camera import Camera, undistort_points

NAME = "rgbd_depth"
FUNCTION = "rgbd_depth_kernel"  # the __global__ function it launches
SOURCE = "orbslam2_tpu_torch/kernels/csrc/rgbd_depth.cu"
REPLACES = "orbslam2_tpu/tracking.py:436"
launches = 0


def _f32(v) -> float:
    return float(np.float32(v))


def rgbd_depth_plain(depth_q: torch.Tensor, depth_scale: float, xy: torch.Tensor,
                     valid: torch.Tensor, cam: Camera, stride: int = 1
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(xy_undist, ur, depth): the keypoints undistorted (``xy`` itself for a
    camera without distortion), and the millimetre-quantised depth map (the
    host-subsampled depth[::stride, ::stride], any integer dtype) sampled at
    the rounded raw keypoint, with u_r = u_undist - bf / d (-1 where there
    is no depth)."""
    xy_u = undistort_points(cam, xy) if cam.has_distortion else xy
    H, W = depth_q.shape
    inv = 1.0 / float(stride)
    xi = torch.round(xy[:, 0] * inv).long().clamp(0, W - 1)
    yi = torch.round(xy[:, 1] * inv).long().clamp(0, H - 1)
    d = depth_q.reshape(-1).to(torch.int32)[yi * W + xi].float() * depth_scale
    ok = valid & (d > 0)
    neg = torch.full_like(d, -1.0)
    # an IEEE division of two tensors (a Python-scalar numerator becomes a
    # reciprocal and a product)
    bf_d = torch.full_like(d, cam.bf) / d.clamp_min(1e-6)
    return xy_u, torch.where(ok, xy_u[:, 0] - bf_d, neg), torch.where(ok, d, neg)


def rgbd_depth(depth_q: torch.Tensor, depth_scale: float, xy: torch.Tensor,
               valid: torch.Tensor, cam: Camera, stride: int = 1
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel L on CUDA tensors (depth as uint16), the plain version on CPU
    tensors."""
    if xy.device.type == "cpu":
        return rgbd_depth_plain(depth_q, depth_scale, xy, valid, cam, stride)
    dev = xy.device
    n = xy.shape[0]
    if depth_q.dim() != 2:
        raise ValueError(f"{NAME}: want a 2-D depth map, got {tuple(depth_q.shape)}")
    H, W = depth_q.shape
    build.expect(NAME, dev, [("depth", depth_q, torch.uint16, (H, W)),
                             ("xy", xy, torch.float32, (n, 2)),
                             ("valid", valid, torch.bool, (n,))])
    distort = cam.has_distortion
    xy_u = torch.empty_like(xy) if distort else xy
    ur = torch.empty(n, dtype=torch.float32, device=dev)
    depth = torch.empty_like(ur)
    err = build.library().osl_rgbd_depth(
        depth_q.data_ptr(), H, W, xy.data_ptr(), valid.data_ptr(), n,
        _f32(1.0 / float(stride)), _f32(depth_scale), _f32(cam.bf), int(distort),
        cam.fx, cam.fy, cam.cx, cam.cy, cam.k1, cam.k2, cam.p1, cam.p2, cam.k3,
        xy_u.data_ptr() if distort else None, ur.data_ptr(), depth.data_ptr(),
        build.stream_handle(dev))
    build.check(err, NAME)
    build.count_launch(__name__)
    return xy_u, ur, depth
