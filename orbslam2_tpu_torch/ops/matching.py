"""Descriptor matching: the ORBmatcher re-design (port of
``orbslam2_tpu.ops.matching``, plain PyTorch).

Every SearchBy* overload is the same batched pattern: pair mask (geometry
gates) -> masked Hamming top-2 -> distance / ratio / mutual / rotation
gates. On the card its instances run in kernels: the projection tracker's
in C and Q, triangulation's in S, fuse's in T; the matchers here serve the
reference-keyframe fallback and those kernels' plain versions.

Hamming distances come from a float32 product of the unpacked {0,1} bits,
which is exact (sums <= 256) with TF32 off.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

TH_LOW = 50
TH_HIGH = 100
HISTO_LENGTH = 30
INVALID = (2 ** 31 - 1) // 2  # sentinel distance


def unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    """(..., 32) uint8 -> (..., 256) {0,1} uint8, LSB-first per byte."""
    shifts = torch.arange(8, dtype=torch.uint8, device=desc.device)
    bits = (desc[..., :, None] >> shifts) & 1
    return bits.reshape(desc.shape[:-1] + (256,))


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """(..., Na, 32) u8, (..., Nb, 32) u8 -> (..., Na, Nb) int32."""
    a = unpack_bits(desc_a).float()
    b = unpack_bits(desc_b).float()
    dot = a @ b.transpose(-1, -2)
    na = a.sum(-1)[..., :, None]
    nb = b.sum(-1)[..., None, :]
    return torch.round(na + nb - 2.0 * dot).to(torch.int32)


class MatchResult(NamedTuple):
    idx: torch.Tensor    # (Na,) int32 index into B, -1 if unmatched
    dist: torch.Tensor   # (Na,) int32 (INVALID if unmatched)
    valid: torch.Tensor  # (Na,) bool


def masked_top2(dist: torch.Tensor, pair_mask: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(best_idx, best, second, second_idx) along the last axis; masked-out
    pairs count as INVALID, argmin takes the first index on ties and the
    second best excludes only best_idx."""
    if pair_mask is not None:
        dist = torch.where(pair_mask, dist, torch.full_like(dist, INVALID))
    best_idx = dist.argmin(-1)
    best = dist.gather(-1, best_idx[..., None])[..., 0]
    masked = dist.scatter(-1, best_idx[..., None], INVALID)
    second_idx = masked.argmin(-1)
    second = masked.gather(-1, second_idx[..., None])[..., 0]
    return (best_idx.to(torch.int32), best, second,
            second_idx.to(torch.int32))


def rotation_consistency_mask(angle_a: torch.Tensor, angle_b_matched: torch.Tensor,
                              match_valid: torch.Tensor, n_keep: int = 3) -> torch.Tensor:
    """Keep matches whose angle difference falls in the top-``n_keep`` bins
    of a HISTO_LENGTH-bin rotation histogram (bins 2 and 3 only within 10%
    of the largest count)."""
    two_pi = 2.0 * math.pi
    diff = torch.remainder(angle_a - angle_b_matched, two_pi)
    bins = (diff * (HISTO_LENGTH / two_pi)).to(torch.int32).clamp(0, HISTO_LENGTH - 1)
    counts = torch.zeros(HISTO_LENGTH, dtype=torch.int32, device=angle_a.device)
    counts = counts.index_add(0, bins.long(), match_valid.to(torch.int32))
    # top-k with the lowest index first among equal counts (lax.top_k order)
    order = torch.argsort(-counts, stable=True)[:n_keep]
    top_vals = counts[order]
    keep = top_vals >= torch.clamp((0.1 * top_vals[0].float()).to(torch.int32), min=1)
    keep_bin = torch.zeros(HISTO_LENGTH, dtype=torch.bool, device=angle_a.device)
    keep_bin[order] = keep
    return match_valid & keep_bin[bins.long()]


def match_descriptors(
    desc_a: torch.Tensor,
    desc_b: torch.Tensor,
    valid_a: torch.Tensor,
    valid_b: torch.Tensor,
    pair_mask: Optional[torch.Tensor] = None,
    max_dist: int = TH_LOW,
    nn_ratio: float = 1.0,
    angles_a: Optional[torch.Tensor] = None,
    angles_b: Optional[torch.Tensor] = None,
    check_rotation: bool = False,
    mutual: bool = False,
    octave_b: Optional[torch.Tensor] = None,
    ratio_same_level_only: bool = False,
) -> MatchResult:
    """The parameterized matcher all SearchBy* variants reduce to; batched
    over leading dimensions except for ``check_rotation`` and
    ``ratio_same_level_only`` (single problems)."""
    dist = hamming_matrix(desc_a, desc_b)
    mask = valid_a[..., :, None] & valid_b[..., None, :]
    if pair_mask is not None:
        mask = mask & pair_mask
    best_idx, best, second, second_idx = masked_top2(dist, mask)

    ok = (best <= max_dist) & valid_a
    if nn_ratio < 1.0:
        ratio_ok = best.float() < nn_ratio * second.float()
        if ratio_same_level_only and octave_b is not None:
            same_lvl = octave_b[best_idx.long()] == octave_b[second_idx.long()]
            ratio_ok = ratio_ok | ~same_lvl
        ok = ok & ratio_ok
    if mutual:
        bbest_idx, _, _, _ = masked_top2(dist.transpose(-1, -2),
                                         mask.transpose(-1, -2))
        arange_a = torch.arange(desc_a.shape[-2], device=desc_a.device,
                                dtype=torch.int32)
        back = bbest_idx.gather(-1, best_idx.long())
        ok = ok & (back == arange_a)
    if check_rotation and angles_a is not None and angles_b is not None:
        ok = rotation_consistency_mask(angles_a, angles_b[best_idx.long()], ok)

    return MatchResult(
        idx=torch.where(ok, best_idx, torch.full_like(best_idx, -1)),
        dist=torch.where(ok, best, torch.full_like(best, INVALID)),
        valid=ok,
    )


# ---------------------------------------------------------------------------
# Geometry gate builders
# ---------------------------------------------------------------------------

def radius_gate(proj_xy: torch.Tensor, kp_xy: torch.Tensor,
                radius: torch.Tensor) -> torch.Tensor:
    """(..., Na, 2) projections vs (..., Nb, 2) keypoints within the per-A
    radius: dx^2 + dy^2 <= r^2."""
    d = proj_xy[..., :, None, :] - kp_xy[..., None, :, :]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    return d2 <= (radius * radius)[..., :, None]


def octave_gate(octave_a: torch.Tensor, octave_b: torch.Tensor, lo: int = 0,
                hi: int = 0) -> torch.Tensor:
    diff = octave_b[..., None, :] - octave_a[..., :, None]
    return (diff >= lo) & (diff <= hi)


def epipolar_gate(kp1_xy: torch.Tensor, kp2_xy: torch.Tensor, F12: torch.Tensor,
                  sigma2_level2: torch.Tensor) -> torch.Tensor:
    """Pairs whose point-to-epipolar-line distance^2 < 3.84 sigma^2 of the
    level of kp2; batched over leading dimensions. The lines F12 (x, y, 1)
    are written term by term, in kernel S's order (a matrix product would
    let the card's library contract or reorder the sums)."""
    x, y = kp1_xy[..., 0], kp1_xy[..., 1]
    F = F12[..., None, :, :]
    a, b, c = (x * F[..., k, 0] + y * F[..., k, 1] + F[..., k, 2] for k in range(3))
    a, b, c = a[..., None], b[..., None], c[..., None]
    num = a * kp2_xy[..., None, :, 0] + b * kp2_xy[..., None, :, 1] + c
    den = a * a + b * b
    d2 = (num * num) / den.clamp_min(1e-12)
    return d2 < 3.84 * sigma2_level2[..., None, :]


def fundamental_from_poses(K1: torch.Tensor, K2: torch.Tensor, T1w: torch.Tensor,
                           T2w: torch.Tensor) -> torch.Tensor:
    """F21 = K2^-T [t21]x R21 K1^-1 (x2^T F21 x1 = 0); batched."""
    from . import geometry as geo

    T21 = T2w @ geo.se3_inverse(T1w)
    E = geo.hat(T21[..., :3, 3]) @ T21[..., :3, :3]
    return torch.linalg.inv(K2).transpose(-1, -2) @ E @ torch.linalg.inv(K1)
