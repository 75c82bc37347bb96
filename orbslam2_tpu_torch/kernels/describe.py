"""Kernel B wrapper: intensity-centroid angle + steered BRIEF descriptor.

Replaces ``orbslam2_tpu/ops/orb.py``: ``ic_angles_conv`` and
``brief_descriptors_flat``. CUDA source: ``csrc/orb_describe.cu`` (one warp
per keypoint; bound by the latency of its ~1200 scattered L2 reads, so it
stages nothing and keeps every keypoint's work in one warp). The moments are
a direct sum over the radius-15 circle in both versions: exact on integer
images (level 0), rounding-order dependent above; descriptors then agree
wherever the rotated pattern offsets round the same.
"""

from __future__ import annotations

import functools
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from . import build

NAME = "orb_describe"
FUNCTION = "orb_describe_kernel"  # the __global__ function it launches
SOURCE = "orbslam2_tpu_torch/kernels/csrc/orb_describe.cu"
REPLACES = "orbslam2_tpu/ops/orb.py:341"
launches = 0

IC_R = 15  # intensity-centroid radius (reference HALF_PATCH_SIZE)


@functools.lru_cache()
def ic_weight_tables() -> Tuple[np.ndarray, np.ndarray]:
    """(31, 31) x/y moment weights over the radius-15 circle, with the
    reference's per-row extent umax[v] = round(sqrt(15^2 - v^2))."""
    d = np.arange(-IC_R, IC_R + 1)
    dy, dx = d[:, None], d[None, :]
    umax = np.round(np.sqrt(np.maximum(IC_R * IC_R - dy * dy, 0.0)))
    mask = np.abs(dx) <= umax
    return (dx * mask).astype(np.float32), (dy * mask).astype(np.float32)


@functools.lru_cache()
def _pattern_xy() -> np.ndarray:
    """(512, 2) int32 (x, y): the 256 first test points, then the 256
    second ones."""
    from ..utils.convert import brief_pattern

    pa, pb = brief_pattern()
    return np.ascontiguousarray(np.concatenate([pa, pb]).astype(np.int32))


_pattern_dev = {}
_pattern_lock = threading.Lock()


def _pattern_on(device) -> torch.Tensor:
    key = str(device)
    with _pattern_lock:
        if key not in _pattern_dev:
            _pattern_dev[key] = torch.from_numpy(_pattern_xy()).to(device)
        return _pattern_dev[key]


def orb_describe_plain(img: torch.Tensor, blurred: torch.Tensor,
                       xy: torch.Tensor, upright: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(angle (n,) f32, desc (n, 32) u8) for integer level coords xy (n, 2).
    Reads are clamped to the level."""
    H, W = img.shape
    dev = img.device
    xy = xy.long()
    offs = torch.arange(-IC_R, IC_R + 1, device=dev)
    rows = (xy[:, 1:2] + offs[None]).clamp(0, H - 1)
    cols = (xy[:, 0:1] + offs[None]).clamp(0, W - 1)
    patch = img[rows[:, :, None], cols[:, None, :]]             # (n, 31, 31)
    wx, wy = (torch.from_numpy(w).to(dev) for w in ic_weight_tables())
    m10 = (patch * wx).sum((1, 2))
    m01 = (patch * wy).sum((1, 2))
    angle = torch.atan2(m01, m10)

    pat = _pattern_on(dev).float()
    px, py = pat[:, 0][None], pat[:, 1][None]                   # (1, 512)
    a = torch.zeros_like(angle) if upright else angle
    c = torch.cos(a)[:, None]
    s = torch.sin(a)[:, None]
    rc = torch.round(px * c - py * s).long()
    rr = torch.round(px * s + py * c).long()
    yy = (xy[:, 1:2] + rr).clamp(0, H - 1)
    xx = (xy[:, 0:1] + rc).clamp(0, W - 1)
    vals = blurred.reshape(-1)[yy * W + xx]                     # (n, 512)
    bits = (vals[:, :256] < vals[:, 256:]).to(torch.int32).reshape(-1, 32, 8)
    weights = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.int32,
                           device=dev)
    desc = (bits * weights).sum(-1).to(torch.uint8)
    return angle, desc


def orb_describe(img: torch.Tensor, blurred: torch.Tensor, xy: torch.Tensor,
                 upright: bool = False,
                 out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B on CUDA tensors, the plain version on CPU tensors. With
    ``out`` = (angle (n,) f32, desc (n, 32) u8), views of the frame's
    buffers, the results are written there and returned."""
    if img.device.type == "cpu":
        angle, desc = orb_describe_plain(img, blurred, xy, upright)
        if out is None:
            return angle, desc
        out[0].copy_(angle)
        out[1].copy_(desc)
        return out
    if not (img.is_cuda and blurred.device == img.device
            and xy.device == img.device):
        raise ValueError(f"{NAME}: all inputs must be on one CUDA device")
    if img.dtype != torch.float32 or blurred.shape != img.shape:
        raise ValueError(f"{NAME}: want float32 level and blurred level of "
                         f"one shape")
    img = img.contiguous()
    blurred = blurred.contiguous()
    xy = xy.to(torch.int32).contiguous()
    n = xy.shape[0]
    H, W = img.shape
    if out is None:
        out = (torch.empty(n, dtype=torch.float32, device=img.device),
               torch.empty((n, 32), dtype=torch.uint8, device=img.device))
    build.expect(NAME, img.device, [("out angle", out[0], torch.float32, (n,)),
                                    ("out desc", out[1], torch.uint8, (n, 32))])
    angle, desc = out
    err = build.library().osl_orb_describe(
        img.data_ptr(), blurred.data_ptr(), xy.data_ptr(), n,
        _pattern_on(img.device).data_ptr(), H, W, int(bool(upright)),
        angle.data_ptr(), desc.data_ptr(), build.stream_handle(img.device))
    build.check(err, NAME)
    build.count_launch(__name__)
    return angle, desc
