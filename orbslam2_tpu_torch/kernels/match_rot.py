"""Kernel U wrapper: the mutual, rotation-checked descriptor matcher.

Replaces ``orbslam2_tpu/ops/matching.py``: ``match_descriptors`` with
``mutual=True`` and ``check_rotation=True``, with no pair mask (the
reference-keyframe fallback: TH_LOW, ratio 0.7) or the radius window of
``orbslam2_tpu/tracking.py``: ``match_frames_windowed``
(SearchForInitialization: TH_LOW, ratio 0.9, 100 px); with
``check_rotation=False``, ``match_descriptors(mutual=True)`` with no
rotation check (relocalization: TH_LOW, ratio 0.75). CUDA source:
``csrc/match_rot.cu`` (a warp per A row with the B->A best posted by a
64-bit atomicMin, then one block for the gates and the 30-bin rotation
histogram; idx, dist and valid bit-exact against the plain version).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import build
from ..ops import matching

NAME = "match_rot"
FUNCTION = "match_rot"  # both its __global__ functions hold this name
SOURCE = "orbslam2_tpu_torch/kernels/csrc/match_rot.cu"
REPLACES = "orbslam2_tpu/ops/matching.py:111"
MAX_A = 8192  # rows the gates launch keeps in shared memory
launches = 0

_TWO_PI = 2.0 * math.pi


def match_rot_plain(desc_a, desc_b, valid_a, valid_b, angles_a, angles_b,
                    max_dist: int, nn_ratio: float, xy_a=None, xy_b=None,
                    window: Optional[float] = None,
                    check_rotation: bool = True) -> matching.MatchResult:
    """``match_descriptors(..., mutual=True, check_rotation=...)``; with
    ``window`` the pair mask is ``radius_gate(xy_a, xy_b, window)``."""
    pair = None
    if window is not None:
        r = torch.full((xy_a.shape[0],), float(window), dtype=xy_a.dtype,
                       device=xy_a.device)
        pair = matching.radius_gate(xy_a, xy_b, r)
    return matching.match_descriptors(
        desc_a, desc_b, valid_a, valid_b, pair_mask=pair, max_dist=max_dist,
        nn_ratio=nn_ratio, angles_a=angles_a, angles_b=angles_b,
        check_rotation=check_rotation, mutual=True)


def match_rot(desc_a, desc_b, valid_a, valid_b, angles_a, angles_b,
              max_dist: int, nn_ratio: float, xy_a=None, xy_b=None,
              window: Optional[float] = None,
              check_rotation: bool = True) -> matching.MatchResult:
    """Kernel U on CUDA tensors, the plain version on CPU tensors. The
    angles are read only with ``check_rotation``."""
    if desc_a.device.type == "cpu":
        return match_rot_plain(desc_a, desc_b, valid_a, valid_b, angles_a,
                               angles_b, max_dist, nn_ratio, xy_a, xy_b, window,
                               check_rotation)
    dev = desc_a.device
    Na, Nb = desc_a.shape[0], desc_b.shape[0]
    if Na > MAX_A:
        raise ValueError(f"{NAME}: Na={Na} > {MAX_A}")
    specs = [("desc_a", desc_a, torch.uint8, (Na, 32)),
             ("desc_b", desc_b, torch.uint8, (Nb, 32)),
             ("valid_a", valid_a, torch.bool, (Na,)),
             ("valid_b", valid_b, torch.bool, (Nb,))]
    if check_rotation:
        specs += [("angles_a", angles_a, torch.float32, (Na,)),
                  ("angles_b", angles_b, torch.float32, (Nb,))]
    if window is not None:
        specs += [("xy_a", xy_a, torch.float32, (Na, 2)),
                  ("xy_b", xy_b, torch.float32, (Nb, 2))]
    build.expect(NAME, dev, specs)
    rows = torch.empty((3, Na), dtype=torch.int32, device=dev)
    col_key = torch.empty(max(Nb, 1), dtype=torch.int64, device=dev)
    out = matching.MatchResult(torch.empty(Na, dtype=torch.int32, device=dev),
                               torch.empty(Na, dtype=torch.int32, device=dev),
                               torch.empty(Na, dtype=torch.bool, device=dev))
    use_window = window is not None
    err = build.library().osl_match_rot(
        desc_a.data_ptr(), valid_a.data_ptr(),
        xy_a.data_ptr() if use_window else None,
        angles_a.data_ptr() if check_rotation else None, Na,
        desc_b.data_ptr(), valid_b.data_ptr(),
        xy_b.data_ptr() if use_window else None,
        angles_b.data_ptr() if check_rotation else None, Nb,
        float(window) if use_window else 0.0, int(use_window), int(max_dist),
        float(nn_ratio), int(nn_ratio < 1.0), int(check_rotation), _TWO_PI,
        matching.HISTO_LENGTH / _TWO_PI, rows[0].data_ptr(), rows[1].data_ptr(),
        rows[2].data_ptr(), col_key.data_ptr(), out.idx.data_ptr(),
        out.dist.data_ptr(), out.valid.data_ptr(), build.stream_handle(dev))
    build.check(err, NAME)
    build.count_launch(__name__)
    return out
