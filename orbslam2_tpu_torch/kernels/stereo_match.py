"""Kernel V wrapper: the stereo matcher's descriptor half.

Replaces ``orbslam2_tpu/ops/stereo.py``: ``stereo_match`` (the row, disparity
and octave gates, TH_HIGH and the 0.9 ratio test, then u_right and depth).
CUDA source: ``csrc/stereo_match.cu`` (a warp per left keypoint, the gates
evaluated in the kernel, the (N, N) masks and distances never stored;
u_right and depth bit-exact against the plain version).
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import build
from ..ops import matching

NAME = "stereo_match"
FUNCTION = "stereo_match_kernel"  # the __global__ function it launches
SOURCE = "orbslam2_tpu_torch/kernels/csrc/stereo_match.cu"
REPLACES = "orbslam2_tpu/ops/stereo.py:27"
launches = 0


def stereo_match_plain(l_xy, l_oct, l_desc, l_valid, r_xy, r_oct, r_desc,
                       r_valid, scale_factors, bf: float, min_depth: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u_right, depth) per left keypoint, -1 where unmatched."""
    dev = l_xy.device
    vr, vl = r_xy[:, 1], l_xy[:, 1]
    row_tol = 2.0 * scale_factors[l_oct.long()]
    row_ok = (vl[:, None] - vr[None, :]).abs() <= row_tol[:, None]
    disp = l_xy[:, 0:1] - r_xy[None, :, 0]
    bf_t = torch.tensor(bf, dtype=torch.float32, device=dev)
    max_disp = bf_t / torch.tensor(min_depth, dtype=torch.float32,
                                   device=dev).clamp_min(1e-6)
    disp_ok = (disp > 0.1) & (disp <= max_disp)
    pair = row_ok & disp_ok & matching.octave_gate(l_oct, r_oct, lo=-1, hi=1)
    res = matching.match_descriptors(l_desc, r_desc, l_valid, r_valid,
                                     pair_mask=pair, max_dist=matching.TH_HIGH,
                                     nn_ratio=0.9)
    neg = torch.full_like(l_xy[:, 0], -1.0)
    ur = torch.where(res.valid, r_xy[res.idx.clamp_min(0).long(), 0], neg)
    d = l_xy[:, 0] - ur
    depth = torch.where(res.valid & (d > 0.1), bf_t / d.clamp_min(0.1), neg)
    ur = torch.where(depth > 0, ur, neg)
    return ur, depth


def stereo_match(l_xy, l_oct, l_desc, l_valid, r_xy, r_oct, r_desc, r_valid,
                 scale_factors, bf: float, min_depth: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel V on CUDA tensors, the plain version on CPU tensors."""
    if l_xy.device.type == "cpu":
        return stereo_match_plain(l_xy, l_oct, l_desc, l_valid, r_xy, r_oct,
                                  r_desc, r_valid, scale_factors, bf, min_depth)
    dev = l_xy.device
    Nl, Nr = l_xy.shape[0], r_xy.shape[0]
    build.expect(NAME, dev, (
        ("l_xy", l_xy, torch.float32, (Nl, 2)),
        ("l_oct", l_oct, torch.int32, (Nl,)),
        ("l_desc", l_desc, torch.uint8, (Nl, 32)),
        ("l_valid", l_valid, torch.bool, (Nl,)),
        ("r_xy", r_xy, torch.float32, (Nr, 2)),
        ("r_oct", r_oct, torch.int32, (Nr,)),
        ("r_desc", r_desc, torch.uint8, (Nr, 32)),
        ("r_valid", r_valid, torch.bool, (Nr,)),
        ("scale_factors", scale_factors, torch.float32,
         (scale_factors.shape[0],))))
    ur = torch.empty(Nl, dtype=torch.float32, device=dev)
    depth = torch.empty(Nl, dtype=torch.float32, device=dev)
    err = build.library().osl_stereo_match(
        l_xy.data_ptr(), l_oct.data_ptr(), l_desc.data_ptr(), l_valid.data_ptr(),
        Nl, r_xy.data_ptr(), r_oct.data_ptr(), r_desc.data_ptr(),
        r_valid.data_ptr(), Nr, scale_factors.data_ptr(), float(bf),
        float(min_depth), ur.data_ptr(), depth.data_ptr(),
        build.stream_handle(dev))
    build.check(err, NAME)
    build.count_launch(__name__)
    return ur, depth
