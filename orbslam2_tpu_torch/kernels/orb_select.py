"""Kernel J wrapper: FAST keypoint selection of one pyramid level.

Replaces ``orbslam2_tpu/ops/orb.py:138-197``, the part of ``detect_level``
after the score and the NMS (kernel A): the per-cell dual threshold, the
per-cell top-8, the round-robin selection of the level's budget and the
parabola subpixel offsets. CUDA source: ``csrc/orb_select.cu`` (one block
per level; a warp per 32x32 cell for the threshold and the top-8, then a
bitonic sort of the (cells * 8) keys in shared memory). It writes straight
into the frame's feature buffers when given them (``out``). Bit-exact
against ``orb_select_plain``, invalid slots included.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from . import build

NAME = "orb_select"
FUNCTION = "orb_select_kernel"  # the __global__ function it launches
SOURCE = "orbslam2_tpu_torch/kernels/csrc/orb_select.cu"
REPLACES = "orbslam2_tpu/ops/orb.py:138"
launches = 0

CELL = 32             # selection cell size in pixels
TOPK_PER_CELL = 8     # candidates kept per cell before the round-robin
# the keys (cells * 8, padded to a power of two) and their scores sit in one
# block's shared memory: 8192 keys are 1024 cells, e.g. 1280x720 (920)
MAX_KEYS = 8192


class Selection(NamedTuple):
    """Where a level's selection goes: views of the frame's buffers."""
    xy: torch.Tensor        # (n, 2) float32, level-0 coords
    response: torch.Tensor  # (n,) float32
    octave: torch.Tensor    # (n,) int32
    valid: torch.Tensor     # (n,) bool


def _parabola(l, c, r):
    """Vertex offset of the parabola through (-1,l),(0,c),(1,r), clamped."""
    den = 2.0 * c - l - r
    off = torch.where(den > 1e-6, 0.5 * (r - l) / den.clamp_min(1e-6),
                      torch.zeros_like(den))
    return off.clamp(-0.5, 0.5)


def orb_select_plain(S_raw: torch.Tensor, S: torch.Tensor, n_out: int,
                     ini_th: float, min_th: float):
    """Cell dual threshold, per-cell top-8, round-robin selection of n_out
    keypoints and parabola subpixel offsets, from kernel A's outputs, with
    the reference's tie rules (the first index wins among equal scores, in
    the per-cell top-8 and in the round-robin; both thresholds are strict
    ``>``).

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


def n_keys(H: int, W: int) -> int:
    return ((H + CELL - 1) // CELL) * ((W + CELL - 1) // CELL) * TOPK_PER_CELL


def orb_select(S_raw: torch.Tensor, S: torch.Tensor, n_out: int, ini_th: float,
               min_th: float, scale: float = 1.0, level: int = 0,
               out: Optional[Selection] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel J on CUDA tensors, the plain version on CPU tensors. Returns
    (xy_int (n_out, 2) int32 level coords, xy_sub * scale, response,
    valid); with ``out`` the last three are its views, written in place, and
    ``out.octave`` is filled with ``level``. Raises above ``MAX_KEYS`` keys
    or where ``n_out`` exceeds them."""
    H, W = S.shape
    if n_out > n_keys(H, W):
        raise ValueError(f"{NAME}: n_out={n_out} above the {n_keys(H, W)} "
                         f"candidates of a {H}x{W} level")
    if S.device.type == "cpu":
        xy_i, xy_sub, resp, valid = orb_select_plain(S_raw, S, n_out, ini_th, min_th)
        xy = xy_sub * float(scale)
        if out is None:
            return xy_i, xy, resp, valid
        out.xy.copy_(xy)
        out.response.copy_(resp)
        if out.octave is not None:
            out.octave.fill_(level)
        out.valid.copy_(valid)
        return xy_i, out.xy, out.response, out.valid
    dev = S.device
    build.expect(NAME, dev, [("S_raw", S_raw, torch.float32, (H, W)),
                             ("S", S, torch.float32, (H, W))])
    if n_keys(H, W) > MAX_KEYS:
        raise ValueError(f"{NAME}: a {H}x{W} level has {n_keys(H, W)} keys, "
                         f"above the {MAX_KEYS} one block sorts")
    if out is None:
        out = Selection(torch.empty((n_out, 2), dtype=torch.float32, device=dev),
                        torch.empty(n_out, dtype=torch.float32, device=dev),
                        None, torch.empty(n_out, dtype=torch.bool, device=dev))
    build.expect(NAME, dev, [("out.xy", out.xy, torch.float32, (n_out, 2)),
                             ("out.response", out.response, torch.float32, (n_out,)),
                             ("out.valid", out.valid, torch.bool, (n_out,))]
                 + ([] if out.octave is None else
                    [("out.octave", out.octave, torch.int32, (n_out,))]))
    xy_i = torch.empty((n_out, 2), dtype=torch.int32, device=dev)
    if n_out == 0:
        return xy_i, out.xy, out.response, out.valid
    err = build.library().osl_orb_select(
        S_raw.data_ptr(), S.data_ptr(), H, W, n_out, float(ini_th),
        float(min_th), float(scale), int(level), xy_i.data_ptr(),
        out.xy.data_ptr(), out.response.data_ptr(),
        None if out.octave is None else out.octave.data_ptr(),
        out.valid.data_ptr(), build.stream_handle(dev))
    build.check(err, NAME)
    build.count_launch(__name__)
    return xy_i, out.xy, out.response, out.valid
