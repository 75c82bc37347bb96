"""ORB feature extraction: FAST-9/16 + oriented BRIEF (port of
``orbslam2_tpu.ops.orb``).

Per pyramid level: kernel A (``kernels/fast_score.py``) computes the FAST
score, the border mask and the 3x3 NMS; the cell selection below is plain
PyTorch with the reference's tie rules (the first index wins among equal
scores, in the per-cell top-8 and in the round-robin, and both thresholds
are strict ``>``); kernel
B (``kernels/describe.py``) computes the intensity-centroid angle on the level
and the steered BRIEF descriptor on its 7x7 sigma=2 blur.

Outputs are fixed-capacity arrays with validity masks, in the reference's
layouts: xy (N, 2) f32 level-0 coords, octave (N,) i32, desc (N, 32) u8.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from . import image as img_ops
from ..config import ExtractorConfig
from ..device import DEFAULT as DEFAULT_DEVICE, resolve as resolve_device
from ..kernels import describe as _describe
from ..kernels import fast_score as _fast_score

PATCH_R = 20          # keypoints stay this far from the level border
CELL = 32             # selection cell size in pixels
TOPK_PER_CELL = 8     # candidates kept per cell before the round-robin


class Features(NamedTuple):
    xy: torch.Tensor        # (N, 2) float32, level-0 coords
    response: torch.Tensor  # (N,) float32 FAST corner measure
    angle: torch.Tensor     # (N,) float32 radians
    octave: torch.Tensor    # (N,) int32 pyramid level
    desc: torch.Tensor      # (N, 32) uint8 packed 256-bit rBRIEF
    valid: torch.Tensor     # (N,) bool


def _parabola(l, c, r):
    """Vertex offset of the parabola through (-1,l),(0,c),(1,r), clamped."""
    den = 2.0 * c - l - r
    off = torch.where(den > 1e-6, 0.5 * (r - l) / den.clamp_min(1e-6),
                      torch.zeros_like(den))
    return off.clamp(-0.5, 0.5)


def select_level(S_raw: torch.Tensor, S: torch.Tensor, n_out: int,
                 ini_th: float, min_th: float):
    """Cell dual threshold, per-cell top-8, round-robin selection of n_out
    keypoints and parabola subpixel offsets, from kernel A's outputs.

    Returns (xy_int (n_out, 2) int32, xy_sub (n_out, 2) f32, response,
    valid), all in level coordinates.
    """
    H, W = S.shape
    dev = S.device
    Hp = ((H + CELL - 1) // CELL) * CELL
    Wp = ((W + CELL - 1) // CELL) * CELL
    Sp = torch.full((Hp, Wp), -1.0, dtype=S.dtype, device=dev)
    Sp[:H, :W] = S
    Hc, Wc = Hp // CELL, Wp // CELL

    # dual threshold per cell: the high one where it fires, else the low one
    cell_max = Sp.reshape(Hc, CELL, Wc, CELL).amax(dim=(1, 3))
    cell_th = torch.where(cell_max > ini_th, ini_th, min_th)
    th_full = cell_th.repeat_interleave(CELL, 0).repeat_interleave(CELL, 1)
    Sp = torch.where(Sp > th_full, Sp, torch.full_like(Sp, -1.0))

    # per-cell top-k: the reference's K rounds of (argmax, mask) take the
    # largest value with the first index on ties each round, which is the
    # head of a stable descending sort (torch.topk does not promise it)
    cells = Sp.reshape(Hc, CELL, Wc, CELL).permute(0, 2, 1, 3).reshape(
        Hc * Wc, CELL * CELL)
    vals, idx = torch.sort(cells, dim=1, descending=True, stable=True)
    vals = vals[:, :TOPK_PER_CELL]                              # (C, K)
    idx = idx[:, :TOPK_PER_CELL]

    # round-robin priority: rank within the cell dominates, then response
    rank = torch.arange(TOPK_PER_CELL, dtype=torch.float32, device=dev)[None]
    key = torch.where(vals > 0, rank * 4096.0 - vals,
                      torch.full_like(vals, float("inf")))
    flat_key = key.reshape(-1)
    sel = torch.argsort(flat_key, stable=True)[:n_out]
    sel_valid = flat_key[sel] < 1e9

    cell_id = sel // TOPK_PER_CELL
    within = idx.reshape(-1)[sel]
    cy = (cell_id // Wc) * CELL + within // CELL
    cx = (cell_id % Wc) * CELL + within % CELL
    xy = torch.stack([cx, cy], -1).to(torch.int32)
    resp = vals.reshape(-1)[sel]

    cyc = cy.clamp(1, H - 2)
    cxc = cx.clamp(1, W - 2)
    Sf = S_raw.reshape(-1)

    def at(dy, dx):
        return Sf[(cyc + dy) * W + (cxc + dx)]

    c0 = at(0, 0)
    dxo = _parabola(at(0, -1), c0, at(0, 1))
    dyo = _parabola(at(-1, 0), c0, at(1, 0))
    xy_sub = xy.float() + torch.stack([dxo, dyo], -1)
    return xy, xy_sub, torch.where(sel_valid, resp, torch.zeros_like(resp)), sel_valid


def detect_level(img: torch.Tensor, n_out: int, ini_th: float, min_th: float,
                 border: int = PATCH_R):
    """Detect up to n_out FAST keypoints on one pyramid level (kernel A +
    selection)."""
    S_raw, S = _fast_score.fast_score_nms(img, border)
    return select_level(S_raw, S, n_out, ini_th, min_th)


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
        levels = img_ops.build_pyramid(img, cfg.n_levels, cfg.scale_factor)
        out = {k: [] for k in ("xy", "resp", "ang", "oct", "desc", "valid")}
        for lvl, (level_img, n_l) in enumerate(zip(levels, self.budgets)):
            if n_l <= 0:
                continue
            xy_i, xy_sub, resp, valid = detect_level(
                level_img, n_l, float(cfg.ini_th_fast), float(cfg.min_th_fast))
            blurred = img_ops.gaussian_blur(level_img)
            ang, desc = _describe.orb_describe(level_img, blurred, xy_i,
                                               upright=cfg.upright)
            out["xy"].append(xy_sub * float(cfg.scale_factor ** lvl))
            out["resp"].append(resp)
            out["ang"].append(ang)
            out["oct"].append(torch.full((n_l,), lvl, dtype=torch.int32,
                                         device=img.device))
            out["desc"].append(desc)
            out["valid"].append(valid)

        pad = self.n_pad - self.n_total

        def padn(parts, fill=0):
            x = torch.cat(parts)
            tail = torch.full((pad,) + x.shape[1:], fill, dtype=x.dtype,
                              device=x.device)
            return torch.cat([x, tail])

        return Features(
            xy=padn(out["xy"]), response=padn(out["resp"]),
            angle=padn(out["ang"]), octave=padn(out["oct"]),
            desc=padn(out["desc"]), valid=padn(out["valid"], fill=False),
        )

    def __call__(self, img) -> Features:
        if not isinstance(img, torch.Tensor):
            img = torch.as_tensor(img)
        return self.extract(img.to(self.device, torch.float32))
