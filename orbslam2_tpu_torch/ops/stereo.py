"""Stereo matching: left/right ORB correspondence along epipolar rows (port
of ``orbslam2_tpu.ops.stereo``).

Kernel V (``kernels/stereo_match.py``, beside its plain version) matches
every left keypoint against the right keypoints on nearby rows within the
disparity band and one octave, by descriptor distance (TH_HIGH, ratio 0.9).
The subpixel half, the 11x11 SAD scan and parabola fit on the level-0
images, is kernel W (``kernels/stereo_sad.py``), which the tracker calls
directly.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..kernels import stereo_match as _stereo_match
from .orb import Features


def stereo_match(left: Features, right: Features, bf: float, min_depth: float,
                 scale_factors: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u_right, depth) per left feature, -1 where unmatched (kernel V).

    Gates (ComputeStereoMatches): row distance <= 2 * scale(octave_L),
    disparity in (0.1, bf / min_depth], octave within +-1, TH_HIGH
    descriptor distance with the 0.9 best/second ratio."""
    return _stereo_match.stereo_match(
        left.xy, left.octave, left.desc, left.valid, right.xy, right.octave,
        right.desc, right.valid, scale_factors, bf, min_depth)

