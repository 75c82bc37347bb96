"""Image-level ops: separable Gaussian blur, bilinear resize, pyramid (port
of ``orbslam2_tpu.ops.image``, plain PyTorch).

Same arithmetic as the reference: the blur accumulates the seven taps in the
same order, and the resize is the same pair of static interpolation
matrices (cv::resize half-pixel alignment) applied as two float32 matrix
products, so levels >= 1 differ from the reference only by the products'
summation order.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel1d(ksize: int = 7, sigma: float = 2.0) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, ksize: int = 7, sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur of a (H, W) image with reflect padding."""
    k = [float(v) for v in gaussian_kernel1d(ksize, sigma)]
    r = ksize // 2

    def pass_along(x, axis):
        pad = (0, 0, r, r) if axis == 0 else (r, r, 0, 0)
        xp = F.pad(x[None, None], pad, mode="reflect")[0, 0]
        out = torch.zeros_like(x)
        n = x.shape[axis]
        for i in range(ksize):
            sl = xp[i:i + n] if axis == 0 else xp[:, i:i + n]
            out = out + k[i] * sl
        return out

    return pass_along(pass_along(img, 0), 1)


@functools.lru_cache(maxsize=None)
def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Static (n_out, n_in) bilinear interpolation matrix with cv::resize's
    half-pixel centre alignment (src = (dst + 0.5) * scale - 0.5)."""
    s = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    s = np.clip(s, 0.0, n_in - 1.0)
    i0 = np.floor(s).astype(np.int64)
    i1 = np.minimum(i0 + 1, n_in - 1)
    w = s - i0
    M = np.zeros((n_out, n_in), np.float32)
    M[np.arange(n_out), i0] += (1.0 - w).astype(np.float32)
    M[np.arange(n_out), i1] += w.astype(np.float32)
    return M


@functools.lru_cache(maxsize=None)
def _resize_matrix_on(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_resize_matrix(n_in, n_out)).to(device)


def resize_bilinear(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize (H, W) -> out_hw as Ry @ img @ Cx^T."""
    H, W = img.shape
    oh, ow = out_hw
    Ry = _resize_matrix_on(H, oh, img.device)
    Cx = _resize_matrix_on(W, ow, img.device)
    return (Ry @ img) @ Cx.T


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
    shapes = pyramid_shapes(h, w, n_levels, scale_factor)
    levels = [img]
    for lvl in range(1, n_levels):
        levels.append(resize_bilinear(levels[-1], shapes[lvl]))
    return levels
