"""Kernel I wrapper: one pyramid level (bilinear resize + 7x7 Gaussian blur).

Replaces ``orbslam2_tpu/ops/image.py``: ``resize_bilinear`` (the dense
static interpolation matrices as two matrix products) and
``gaussian_blur``, as ``build_pyramid`` and the extractor call them per
level. CUDA source: ``csrc/pyramid.cu`` (one block per 32x16 output tile,
the source rectangle, the resized tile with the blur's halo and the
vertical pass in shared memory; one launch writes the level and its blur).

The plain version here is the same arithmetic: the resize is a two-tap
gather per axis with the reference matrix's own float32 weights (rows pass
first, rounded to float32, then columns), and the blur accumulates the
seven taps in order from 0, vertical pass first. Kernel and plain version
are bit-exact.
"""

from __future__ import annotations

import functools
import threading
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import build

NAME = "pyramid_level"
FUNCTION = "pyramid_level_kernel"  # the __global__ function it launches
SOURCE = "orbslam2_tpu_torch/kernels/csrc/pyramid.cu"
REPLACES = "orbslam2_tpu/ops/image.py:65"
launches = 0

KSIZE = 7
TILE_W, TILE_H = 32, 16   # the kernel's output tile
MAX_SMEM = 48 * 1024      # the staged source rectangle must fit the default


def gaussian_kernel1d(ksize: int = KSIZE, sigma: float = 2.0) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _resize_sources(n_in: int, n_out: int):
    """Per output, the two source indices and the second one's weight, with
    cv::resize's half-pixel centre alignment (src = (dst + 0.5) * scale -
    0.5)."""
    s = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    s = np.clip(s, 0.0, n_in - 1.0)
    i0 = np.floor(s).astype(np.int64)
    i1 = np.minimum(i0 + 1, n_in - 1)
    return i0, i1, s - i0


@functools.lru_cache(maxsize=None)
def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Static (n_out, n_in) bilinear interpolation matrix, as the reference
    builds it."""
    i0, i1, w = _resize_sources(n_in, n_out)
    M = np.zeros((n_out, n_in), np.float32)
    M[np.arange(n_out), i0] += (1.0 - w).astype(np.float32)
    M[np.arange(n_out), i1] += w.astype(np.float32)
    return M


@functools.lru_cache(maxsize=None)
def resize_taps(n_in: int, n_out: int) -> Tuple[np.ndarray, np.ndarray]:
    """The matrix's two nonzeros per output: (n_out, 2) int32 source
    indices and (n_out, 2) float32 weights. Where both taps name one pixel
    (the clipped end) the second weight is 0 and the first is the matrix's
    summed entry, so a * w0 + a * 0 gives the product's value."""
    i0, i1, _ = _resize_sources(n_in, n_out)
    M = resize_matrix(n_in, n_out)
    rows = np.arange(n_out)
    w0 = M[rows, i0]
    w1 = np.where(i1 != i0, M[rows, i1], 0.0).astype(np.float32)
    return np.stack([i0, i1], 1).astype(np.int32), np.stack([w0, w1], 1)


def _span(idx: np.ndarray, n_out: int, tile: int) -> int:
    """The most source pixels along one axis a tile with the blur's halo
    reads."""
    r = KSIZE // 2
    return max(int(idx[min(t + tile + r - 1, n_out - 1), 1]
                   - idx[max(t - r, 0), 0]) + 1 for t in range(0, n_out, tile))


_tables = {}
_tables_lock = threading.Lock()


def _tables_on(in_hw, out_hw, device):
    """Row and column taps on ``device`` and the staged spans, built once
    per shape (by one thread)."""
    key = (in_hw, out_hw, str(device))
    with _tables_lock:
        if key not in _tables:
            (H, W), (oh, ow) = in_hw, out_hw
            ry, wy = resize_taps(H, oh)
            rx, wx = resize_taps(W, ow)
            on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
            _tables[key] = (on(ry), on(wy), on(rx), on(wx),
                            _span(ry, oh, TILE_H), _span(rx, ow, TILE_W))
        return _tables[key]


def resize_plain(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize (H, W) -> out_hw: per output row, then per output
    column, two taps w0 * a + w1 * b."""
    ry, wy, rx, wx, _, _ = _tables_on(tuple(img.shape), tuple(out_hw), img.device)
    rows = wy[:, :1] * img[ry[:, 0].long()] + wy[:, 1:] * img[ry[:, 1].long()]
    return rows[:, rx[:, 0].long()] * wx[:, 0] + rows[:, rx[:, 1].long()] * wx[:, 1]


def blur_plain(img: torch.Tensor, ksize: int = KSIZE, sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur of a (H, W) image with reflect padding,
    vertical pass first, each pass summing k[i] * x from 0 in tap order."""
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


def pyramid_level_plain(src: torch.Tensor, out_hw: Optional[Tuple[int, int]] = None,
                        sigma: float = 2.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(level, blurred level): ``src`` resized to ``out_hw`` (``src``
    itself when None), and its blur."""
    level = src if out_hw is None else resize_plain(src, out_hw)
    return level, blur_plain(level, KSIZE, sigma)


def pyramid_level(src: torch.Tensor, out_hw: Optional[Tuple[int, int]] = None,
                  sigma: float = 2.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel I on a CUDA tensor, the plain version on a CPU tensor. With
    ``out_hw`` None the level is ``src`` and only the blur runs (level 0)."""
    if src.device.type == "cpu":
        return pyramid_level_plain(src, out_hw, sigma)
    if not src.is_cuda or src.dtype != torch.float32 or src.dim() != 2:
        raise ValueError(f"{NAME}: want a 2-D float32 CUDA image, got "
                         f"{src.dtype} {tuple(src.shape)} on {src.device}")
    src = src.contiguous()
    H, W = src.shape
    if min(H, W) <= KSIZE // 2 or (out_hw is not None and min(out_hw) <= KSIZE // 2):
        raise ValueError(f"{NAME}: reflect padding needs more than "
                         f"{KSIZE // 2} pixels a side, got {tuple(src.shape)} "
                         f"-> {out_hw}")
    taps = [float(v) for v in gaussian_kernel1d(KSIZE, sigma)]
    lib = build.library()
    stream = build.stream_handle(src.device)
    if out_hw is None:
        level = src
        blurred = torch.empty_like(src)
        err = lib.osl_pyramid_level(src.data_ptr(), W, None, None, None, None,
                                    0, 0, *taps, None, blurred.data_ptr(),
                                    H, W, stream)
    else:
        oh, ow = (int(v) for v in out_hw)
        ry, wy, rx, wx, span_r, span_c = _tables_on((H, W), (oh, ow), src.device)
        smem = 4 * (span_r + TILE_H + KSIZE - 1) * span_c
        if smem > MAX_SMEM:
            raise ValueError(f"{NAME}: a {H}x{W} -> {oh}x{ow} resize stages "
                             f"{smem} bytes a tile, above {MAX_SMEM}")
        level = torch.empty((oh, ow), dtype=torch.float32, device=src.device)
        blurred = torch.empty_like(level)
        err = lib.osl_pyramid_level(src.data_ptr(), W, ry.data_ptr(),
                                    wy.data_ptr(), rx.data_ptr(), wx.data_ptr(),
                                    span_r, span_c, *taps, level.data_ptr(),
                                    blurred.data_ptr(), oh, ow, stream)
    build.check(err, NAME)
    build.count_launch(__name__)
    return level, blurred
