"""Kernel W wrapper: the stereo matcher's subpixel half.

Replaces ``orbslam2_tpu/ops/stereo.py``: ``subpixel_refine`` (the 11x11 SAD
scan over +-5 px shifts on the level-0 images, the parabola fit, u_right and
depth). CUDA source: ``csrc/stereo_sad.cu`` (a warp per keypoint; u_right and
depth bit-exact against the plain version). It reads the two level-0 images
the extractor calls uploaded.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import build

NAME = "stereo_sad"
FUNCTION = "stereo_sad_kernel"  # the __global__ function it launches
SOURCE = "orbslam2_tpu_torch/kernels/csrc/stereo_sad.cu"
REPLACES = "orbslam2_tpu/ops/stereo.py:68"
SAD_W = 5      # half window (11x11)
SAD_L = 5      # disparity search half range (+-5 px)
launches = 0


def stereo_sad_plain(left_img, right_img, xy_l, ur0, depth0, bf: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Refined (u_right, depth) of the keypoints whose ``depth0`` > 0, -1
    elsewhere."""
    H, W = left_img.shape
    dev = left_img.device
    valid = depth0 > 0
    xl = torch.round(xy_l[:, 0]).long()
    yl = torch.round(xy_l[:, 1]).long()
    xr = torch.round(ur0).long()
    offs = torch.arange(-SAD_W, SAD_W + 1, device=dev)
    rows = (yl[:, None] + offs[None, :]).clamp(0, H - 1)             # (N, 11)
    lcols = (xl[:, None] + offs[None, :]).clamp(0, W - 1)
    Lp = left_img.reshape(-1)[rows[:, :, None] * W + lcols[:, None, :]]
    strip = torch.arange(-SAD_W - SAD_L, SAD_W + SAD_L + 1, device=dev)
    rcols = (xr[:, None] + strip[None, :]).clamp(0, W - 1)           # (N, 21)
    Rs = right_img.reshape(-1)[rows[:, :, None] * W + rcols[:, None, :]]
    sad = torch.stack([(Lp - Rs[:, :, d:d + 2 * SAD_W + 1]).abs().sum((1, 2))
                       for d in range(2 * SAD_L + 1)], 1)            # (N, 11)
    best = sad.argmin(1)
    b_in = best.clamp(1, 2 * SAD_L - 1)
    s0 = sad.gather(1, b_in[:, None])[:, 0]
    sm = sad.gather(1, (b_in - 1)[:, None])[:, 0]
    sp = sad.gather(1, (b_in + 1)[:, None])[:, 0]
    denom = sm - 2.0 * s0 + sp
    delta = torch.where(denom.abs() > 1e-6, 0.5 * (sm - sp) / denom,
                        torch.zeros_like(denom)).clamp(-1.0, 1.0)
    ur = xr.float() + (b_in - SAD_L).float() + delta
    disp = xy_l[:, 0] - ur
    ok = valid & (disp > 0.05)
    neg = torch.full_like(ur, -1.0)
    depth = torch.where(ok, torch.full_like(disp, bf) / disp.clamp_min(0.05), neg)
    return torch.where(ok, ur, neg), depth


def stereo_sad(left_img, right_img, xy_l, ur0, depth0, bf: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel W on CUDA tensors, the plain version on CPU tensors."""
    if left_img.device.type == "cpu":
        return stereo_sad_plain(left_img, right_img, xy_l, ur0, depth0, bf)
    dev = left_img.device
    H, W = left_img.shape
    N = xy_l.shape[0]
    build.expect(NAME, dev, (
        ("left_img", left_img, torch.float32, (H, W)),
        ("right_img", right_img, torch.float32, (H, W)),
        ("xy_l", xy_l, torch.float32, (N, 2)),
        ("ur0", ur0, torch.float32, (N,)),
        ("depth0", depth0, torch.float32, (N,))))
    ur = torch.empty(N, dtype=torch.float32, device=dev)
    depth = torch.empty(N, dtype=torch.float32, device=dev)
    err = build.library().osl_stereo_sad(
        left_img.data_ptr(), right_img.data_ptr(), H, W, xy_l.data_ptr(),
        ur0.data_ptr(), depth0.data_ptr(), N, float(bf), ur.data_ptr(),
        depth.data_ptr(), build.stream_handle(dev))
    build.check(err, NAME)
    build.count_launch(__name__)
    return ur, depth
