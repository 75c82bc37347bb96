"""Kernel A wrapper: FAST-9/16 score map, border mask and 3x3 NMS.

Replaces ``orbslam2_tpu/ops/orb.py``: ``fast_score_map`` and the border mask
+ NMS at the top of ``detect_level``. CUDA source: ``csrc/fast_score_nms.cu``
(one thread per pixel, 32x8 tiles with the NMS halo in shared memory; memory
bound on the H100, so it writes each output once and reads the image from
L2). Bit-exact against ``fast_score_nms_plain``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import build

NAME = "fast_score_nms"
FUNCTION = "fast_score_nms_kernel"  # the __global__ function it launches
SOURCE = "orbslam2_tpu_torch/kernels/csrc/fast_score_nms.cu"
REPLACES = "orbslam2_tpu/ops/orb.py:79"
launches = 0

# Radius-3 Bresenham circle, 16 offsets in ring order (row, col).
FAST_RING = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)


def fast_score_map(img: torch.Tensor) -> torch.Tensor:
    """FAST-9/16 corner measure of every pixel (the largest threshold at
    which 9 contiguous ring pixels are all brighter or all darker); ring
    reads wrap around the image edges."""
    d = torch.stack(
        [torch.roll(img, (-int(dy), -int(dx)), dims=(0, 1)) for dy, dx in FAST_RING]
    ) - img[None]

    def arc_min9(x):
        y = torch.minimum(x, torch.roll(x, -1, dims=0))
        y = torch.minimum(y, torch.roll(y, -2, dims=0))
        y = torch.minimum(y, torch.roll(y, -4, dims=0))
        return torch.minimum(y, torch.roll(x, -8, dims=0))

    bright = arc_min9(d).amax(0)
    dark = arc_min9(-d).amax(0)
    return torch.maximum(bright, dark)


def fast_score_nms_plain(img: torch.Tensor, border: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(S_raw, S_nms): the raw score map, and the score with the border band
    and non-maxima (S < max3x3(S), -inf outside the image) set to -1."""
    H, W = img.shape
    S_raw = fast_score_map(img)
    ys = torch.arange(H, device=img.device)[:, None]
    xs = torch.arange(W, device=img.device)[None, :]
    inside = (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)
    neg1 = torch.full_like(S_raw, -1.0)
    S = torch.where(inside, S_raw, neg1)
    pooled = F.max_pool2d(S[None, None], 3, stride=1, padding=1)[0, 0]
    return S_raw, torch.where(S >= pooled, S, neg1)


def fast_score_nms(img: torch.Tensor, border: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel A on a CUDA tensor, the plain version on a CPU tensor."""
    global launches
    if img.device.type == "cpu":
        return fast_score_nms_plain(img, border)
    if not img.is_cuda or img.dtype != torch.float32 or img.dim() != 2:
        raise ValueError(f"{NAME}: want a 2-D float32 CUDA image, got "
                         f"{img.dtype} {tuple(img.shape)} on {img.device}")
    img = img.contiguous()
    H, W = img.shape
    s_raw = torch.empty_like(img)
    s_nms = torch.empty_like(img)
    err = build.library().osl_fast_score_nms(
        img.data_ptr(), s_raw.data_ptr(), s_nms.data_ptr(), H, W, int(border),
        build.stream_handle(img.device))
    build.check(err, NAME)
    launches += 1
    return s_raw, s_nms
