"""Kernel C wrapper: gated Hamming best / second-best per map point.

Replaces ``orbslam2_tpu/ops/matching.py``: ``hamming_matrix`` +
``masked_top2`` with the pair mask that ``tracking._project_match_opt``
builds from ``radius_gate``, ``octave_gate`` (octave in [pred - 1, pred])
and the u_right window. CUDA source: ``csrc/hamming_top2.cu`` (one warp per
map point, gate evaluated in-kernel, the (P, N) matrix never stored).
The four (P,) integer outputs are bit-exact against the plain version.

The octave window [pred + lo, pred + hi] is a launch argument
(``octave_window=(lo, hi)``, (-1, 0) for the tracking cascade); with
``octave_window=None`` there is none. Loop closing's acceptance count
(``orbslam2_tpu/loop_closing.py``: ``radius_gate`` + ``match_descriptors``
at TH_LOW without a ratio) runs that variant with a 10 px radius.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import build
from ..ops import matching

NAME = "hamming_top2_gated"
FUNCTION = "hamming_top2_kernel"  # the __global__ function it launches
SOURCE = "orbslam2_tpu_torch/kernels/csrc/hamming_top2.cu"
REPLACES = "orbslam2_tpu/ops/matching.py:36"
launches = 0


def projection_pair_mask(proj, r_px, pred_level, ur_pred, row_valid, kp_xy,
                         kp_octave, kp_valid, kp_ur, octave_window=(-1, 0)
                         ) -> torch.Tensor:
    """The (P, N) admissible-pair mask of the projection search."""
    pair = matching.radius_gate(proj, kp_xy, r_px)
    if octave_window is not None:
        pair = pair & matching.octave_gate(pred_level, kp_octave,
                                           lo=octave_window[0],
                                           hi=octave_window[1])
    ur_ok = (kp_ur[None, :] <= 0) | (
        (ur_pred[:, None] - kp_ur[None, :]).abs() <= r_px[:, None])
    return pair & ur_ok & row_valid[:, None] & kp_valid[None, :]


def hamming_top2_gated_plain(mp_desc, proj, r_px, pred_level, ur_pred,
                             row_valid, kp_desc, kp_xy, kp_octave, kp_valid,
                             kp_ur, gate=None, octave_window=(-1, 0)
                             ) -> Tuple[torch.Tensor, ...]:
    """(best_idx, best, second, second_idx), each (P,) int32. Only valid
    rows are evaluated; the others get masked_top2's all-masked answer
    (0, INVALID, INVALID, 0). A closed ``gate`` leaves them unwritten."""
    P = mp_desc.shape[0]
    dev = mp_desc.device
    if not build.gate_open(gate):
        return tuple(torch.empty(P, dtype=torch.int32, device=dev) for _ in range(4))
    best_idx = torch.zeros(P, dtype=torch.int32, device=dev)
    second_idx = torch.zeros(P, dtype=torch.int32, device=dev)
    best = torch.full((P,), matching.INVALID, dtype=torch.int32, device=dev)
    second = best.clone()
    rows = row_valid.nonzero()[:, 0]
    if rows.numel():
        mask = projection_pair_mask(
            proj[rows], r_px[rows], pred_level[rows], ur_pred[rows],
            row_valid[rows], kp_xy, kp_octave, kp_valid, kp_ur, octave_window)
        dist = matching.hamming_matrix(mp_desc[rows], kp_desc)
        bi, b, s, si = matching.masked_top2(dist, mask)
        best_idx[rows], best[rows], second[rows], second_idx[rows] = bi, b, s, si
    return best_idx, best, second, second_idx


def hamming_top2_gated(mp_desc, proj, r_px, pred_level, ur_pred, row_valid,
                       kp_desc, kp_xy, kp_octave, kp_valid, kp_ur, gate=None,
                       octave_window=(-1, 0)) -> Tuple[torch.Tensor, ...]:
    """Kernel C on CUDA tensors, the plain version on CPU tensors. With a
    ``gate`` (count, threshold) it runs only while the device count is below
    the threshold; ``octave_window`` (lo, hi) or None as the plain
    version."""
    global launches
    if mp_desc.device.type == "cpu":
        return hamming_top2_gated_plain(mp_desc, proj, r_px, pred_level,
                                        ur_pred, row_valid, kp_desc, kp_xy,
                                        kp_octave, kp_valid, kp_ur, gate,
                                        octave_window)
    dev = mp_desc.device
    args = dict(mp_desc=(mp_desc, torch.uint8), proj=(proj, torch.float32),
                r_px=(r_px, torch.float32), pred_level=(pred_level, torch.int32),
                ur_pred=(ur_pred, torch.float32), row_valid=(row_valid, torch.bool),
                kp_desc=(kp_desc, torch.uint8), kp_xy=(kp_xy, torch.float32),
                kp_octave=(kp_octave, torch.int32), kp_valid=(kp_valid, torch.bool),
                kp_ur=(kp_ur, torch.float32))
    for name, (t, dtype) in args.items():
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{NAME}: {name} must be {dtype} on {dev}, got "
                             f"{t.dtype} on {t.device}")
    t = {k: v.contiguous() for k, (v, _) in args.items()}
    P, N = mp_desc.shape[0], kp_desc.shape[0]
    if t["mp_desc"].shape != (P, 32) or t["kp_desc"].shape != (N, 32):
        raise ValueError(f"{NAME}: descriptors must be (n, 32)")
    out = [torch.empty(P, dtype=torch.int32, device=dev) for _ in range(4)]
    gate_n, gate_min = build.gate_args(gate)
    oct_on = octave_window is not None
    oct_lo, oct_hi = octave_window if oct_on else (0, 0)
    err = build.library().osl_hamming_top2_gated(
        t["mp_desc"].data_ptr(), t["proj"].data_ptr(), t["r_px"].data_ptr(),
        t["pred_level"].data_ptr(), t["ur_pred"].data_ptr(),
        t["row_valid"].data_ptr(), P, t["kp_desc"].data_ptr(),
        t["kp_xy"].data_ptr(), t["kp_octave"].data_ptr(),
        t["kp_valid"].data_ptr(), t["kp_ur"].data_ptr(), N, int(oct_on),
        int(oct_lo), int(oct_hi), gate_n, gate_min,
        *(o.data_ptr() for o in out), build.stream_handle(dev))
    build.check(err, NAME)
    launches += 1
    return tuple(out)
