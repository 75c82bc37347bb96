"""ORB feature extraction: FAST-9/16 + oriented BRIEF (port of
``orbslam2_tpu.ops.orb``).

Per pyramid level, four kernels: I (``kernels/pyramid.py``) resizes the
level from the previous one and blurs it (7x7, sigma=2); A
(``kernels/fast_score.py``) computes the FAST score, the border mask and the
3x3 NMS; J (``kernels/orb_select.py``) selects the level's keypoints with
the reference's tie rules (the first index wins among equal scores, in the
per-cell top-8 and in the round-robin, and both thresholds are strict
``>``) and the parabola subpixel offsets; B (``kernels/describe.py``)
computes the intensity-centroid angle on the level and the steered BRIEF
descriptor on its blur. J and B write straight into the frame's buffers.

Outputs are fixed-capacity arrays with validity masks, in the reference's
layouts: xy (N, 2) f32 level-0 coords, octave (N,) i32, desc (N, 32) u8.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from . import image as img_ops
from ..config import ExtractorConfig
from ..device import DEFAULT as DEFAULT_DEVICE, resolve as resolve_device, upload
from ..kernels import describe as _describe
from ..kernels import fast_score as _fast_score
from ..kernels import orb_select as _select
from ..kernels import pyramid as _pyramid

PATCH_R = 20          # keypoints stay this far from the level border


class Features(NamedTuple):
    xy: torch.Tensor        # (N, 2) float32, level-0 coords
    response: torch.Tensor  # (N,) float32 FAST corner measure
    angle: torch.Tensor     # (N,) float32 radians
    octave: torch.Tensor    # (N,) int32 pyramid level
    desc: torch.Tensor      # (N, 32) uint8 packed 256-bit rBRIEF
    valid: torch.Tensor     # (N,) bool


# bytes per keypoint of each Features field, in field order
_FIELD_BYTES = ((8, torch.float32, (2,)), (4, torch.float32, ()),
                (4, torch.float32, ()), (4, torch.int32, ()),
                (32, torch.uint8, (32,)), (1, torch.bool, ()))


def empty_features(n: int, device) -> Features:
    """Zeroed Features of capacity n, all six fields views of one buffer
    (one allocation and one fill for the frame)."""
    buf = torch.zeros(n * sum(b for b, _, _ in _FIELD_BYTES), dtype=torch.uint8,
                      device=device)
    fields, o = [], 0
    for nbytes, dtype, tail in _FIELD_BYTES:
        fields.append(buf[o:o + n * nbytes].view(dtype).view((n,) + tail))
        o += n * nbytes
    return Features(*fields)


def detect_level(img: torch.Tensor, n_out: int, ini_th: float, min_th: float,
                 border: int = PATCH_R):
    """Detect up to n_out FAST keypoints on one pyramid level (kernels A +
    J). Returns (xy_int (n_out, 2) int32, xy_sub (n_out, 2) f32, response,
    valid), all in level coordinates."""
    S_raw, S = _fast_score.fast_score_nms(img, border)
    return _select.orb_select(S_raw, S, n_out, ini_th, min_th)


def level_budgets(n_features: int, n_levels: int, scale_factor: float) -> List[int]:
    """Geometric per-level keypoint budgets (reference ORBextractor ctor)."""
    factor = 1.0 / scale_factor
    n_per = n_features * (1 - factor) / (1 - factor ** n_levels)
    budgets = []
    acc = 0
    for lvl in range(n_levels - 1):
        b = int(round(n_per * factor ** lvl))
        budgets.append(b)
        acc += b
    budgets.append(max(n_features - acc, 0))
    return budgets


class OrbExtractor:
    """Whole-frame ORB extraction for a fixed image size on one device.

    Call with a (H, W) grayscale image in [0, 255] (numpy or tensor); get a
    ``Features`` of padded capacity ``cfg.max_keypoints`` on ``device``.
    """

    def __init__(self, cfg: ExtractorConfig, height: int, width: int,
                 device=DEFAULT_DEVICE):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.height, self.width = height, width
        self.shapes = img_ops.pyramid_shapes(height, width, cfg.n_levels,
                                             cfg.scale_factor)
        self.budgets = level_budgets(cfg.n_features, cfg.n_levels,
                                     cfg.scale_factor)
        self.n_total = sum(self.budgets)
        self.n_pad = cfg.max_keypoints
        assert self.n_pad >= self.n_total, (self.n_pad, self.n_total)

    def extract(self, img: torch.Tensor) -> Features:
        cfg = self.cfg
        feats = empty_features(self.n_pad, img.device)
        level = img
        start = 0
        for lvl, (shape, n_l) in enumerate(zip(self.shapes, self.budgets)):
            level, blurred = _pyramid.pyramid_level(level, shape if lvl else None)
            if n_l <= 0:
                continue
            S_raw, S = _fast_score.fast_score_nms(level, PATCH_R)
            end = start + n_l
            xy_i, _, _, _ = _select.orb_select(
                S_raw, S, n_l, float(cfg.ini_th_fast), float(cfg.min_th_fast),
                scale=float(cfg.scale_factor ** lvl), level=lvl,
                out=_select.Selection(feats.xy[start:end], feats.response[start:end],
                                      feats.octave[start:end], feats.valid[start:end]))
            _describe.orb_describe(level, blurred, xy_i, upright=cfg.upright,
                                   out=(feats.angle[start:end], feats.desc[start:end]))
            start = end
        return feats

    def __call__(self, img) -> Features:
        if isinstance(img, torch.Tensor):
            return self.extract(img.to(self.device, torch.float32))
        # a host image goes up without waiting for the stream
        return self.extract(upload(np.asarray(img, np.float32), self.device))
