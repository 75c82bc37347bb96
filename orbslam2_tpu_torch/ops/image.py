"""Image-level ops: separable Gaussian blur, bilinear resize, pyramid (port
of ``orbslam2_tpu.ops.image``).

Every op goes through kernel I (``kernels/pyramid.py``), which on a CUDA
tensor launches one kernel per level for the resize and the blur together
and on a CPU tensor runs its plain version. The resize is the reference's
pair of static interpolation matrices applied as a two-tap gather per axis
(the matrices' two nonzeros per row, with their float32 weights) instead of
two dense matrix products, a TPU layout; the blur accumulates the seven taps
in the reference's order.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..kernels import pyramid as _pyramid


def gaussian_blur(img: torch.Tensor, ksize: int = 7, sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur of a (H, W) image with reflect padding."""
    if img.device.type == "cpu":
        return _pyramid.blur_plain(img, ksize, sigma)
    if ksize != _pyramid.KSIZE:
        raise ValueError(f"gaussian_blur: kernel I blurs with {_pyramid.KSIZE} "
                         f"taps, got ksize={ksize}")
    return _pyramid.pyramid_level(img, None, sigma)[1]


def resize_bilinear(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize (H, W) -> out_hw with cv::resize's half-pixel
    alignment."""
    if img.device.type == "cpu":
        return _pyramid.resize_plain(img, out_hw)
    return _pyramid.pyramid_level(img, out_hw)[0]


def pyramid_shapes(h: int, w: int, n_levels: int, scale_factor: float) -> List[Tuple[int, int]]:
    """Static per-level (H, W), same rounding as the reference."""
    shapes = []
    for lvl in range(n_levels):
        inv = 1.0 / (scale_factor ** lvl)
        shapes.append((int(round(h * inv)), int(round(w * inv))))
    return shapes


def build_pyramid(img: torch.Tensor, n_levels: int, scale_factor: float) -> List[torch.Tensor]:
    """Per-level images; level 0 is the input, each next level is resized
    from the previous one."""
    h, w = img.shape
    levels = [img]
    for shape in pyramid_shapes(h, w, n_levels, scale_factor)[1:]:
        levels.append(resize_bilinear(levels[-1], shape))
    return levels
