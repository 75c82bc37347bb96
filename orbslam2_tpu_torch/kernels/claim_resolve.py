"""Kernel Q wrapper: the match gates after kernel C, the resolution of map
points claiming one keypoint, and kernel D's inputs.

Replaces the back half of ``orbslam2_tpu/tracking.py``:
``_project_match_opt`` (``match_descriptors``' TH_HIGH and same-octave
ratio gates, the two scatter-min passes keeping the lowest distance and then
the lowest point index per keypoint, the gather of the observations and
sigma^2). CUDA source: ``csrc/claim_resolve.cu`` (a 64-bit atomicMin of
(distance << 32 | point) per claim, then a keep-and-gather launch; all
outputs bit-exact against the plain version).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import build, scale
from ..ops import matching

NAME = "claim_resolve"
FUNCTION = "claim_resolve"  # both its __global__ functions hold this name
SOURCE = "orbslam2_tpu_torch/kernels/csrc/claim_resolve.cu"
REPLACES = "orbslam2_tpu/tracking.py:150"
launches = 0


class Claims(NamedTuple):
    kp_of_mp: torch.Tensor  # (P,) int32 claimed keypoint, -1 where none
    keep: torch.Tensor      # (P,) bool
    obs: torch.Tensor       # (P, 3) (x, y, u_right or -1) of the keypoint
    sigma2: torch.Tensor    # (P,) sf^(2 octave) of the keypoint


def _empty(P, dev) -> Claims:
    return Claims(torch.empty(P, dtype=torch.int32, device=dev),
                  torch.empty(P, dtype=torch.bool, device=dev),
                  torch.empty((P, 3), dtype=torch.float32, device=dev),
                  torch.empty(P, dtype=torch.float32, device=dev))


def claim_resolve_plain(best_idx, best, second, second_idx, row_valid, kp_xy,
                        kp_octave, kp_ur, scale_factor: float, max_dist: int,
                        nn_ratio: float, gate=None) -> Claims:
    P = best.shape[0]
    dev = best.device
    if not build.gate_open(gate):
        return _empty(P, dev)
    N = kp_xy.shape[0]
    ok = (best <= max_dist) & row_valid
    ratio_ok = best.float() < nn_ratio * second.float()
    same_lvl = kp_octave[best_idx.long()] == kp_octave[second_idx.long()]
    ok = ok & (ratio_ok | ~same_lvl)
    dist = torch.where(ok, best, torch.full_like(best, matching.INVALID))

    # several map points claiming one keypoint: keep the lowest distance,
    # then the lowest point index
    idx_l = best_idx.long()
    claim = torch.where(ok, idx_l, torch.full_like(idx_l, N - 1))
    kp_best = torch.full((N,), matching.INVALID, dtype=torch.int32, device=dev)
    kp_best = kp_best.scatter_reduce(0, claim, dist, reduce="amin")
    keep = ok & (dist <= kp_best[idx_l])
    pidx = torch.arange(P, dtype=torch.int32, device=dev)
    claim = torch.where(keep, idx_l, torch.full_like(idx_l, N - 1))
    first_claim = torch.full((N,), P, dtype=torch.int32, device=dev)
    first_claim = first_claim.scatter_reduce(
        0, claim, torch.where(keep, pidx, torch.full_like(pidx, P)), reduce="amin")
    keep = keep & (first_claim[idx_l] == pidx)

    idx = torch.where(keep, idx_l, torch.zeros_like(idx_l))
    obs = torch.cat([kp_xy[idx], torch.where(
        keep, kp_ur[idx], torch.full_like(kp_ur[idx], -1.0))[:, None]], 1)
    sigma2 = scale.table(scale_factor, "sig2", dev)[kp_octave[idx].long()]
    kp_of_mp = torch.where(keep, best_idx, torch.full_like(best_idx, -1))
    return Claims(kp_of_mp, keep, obs, sigma2)


def claim_resolve(best_idx, best, second, second_idx, row_valid, kp_xy,
                  kp_octave, kp_ur, scale_factor: float, max_dist: int,
                  nn_ratio: float, gate=None) -> Claims:
    """Kernel Q on CUDA tensors, the plain version on CPU tensors. With a
    ``gate`` (count, threshold) it runs only while the device count is below
    the threshold; otherwise the outputs are left unwritten."""
    if best.device.type == "cpu":
        return claim_resolve_plain(best_idx, best, second, second_idx, row_valid,
                                   kp_xy, kp_octave, kp_ur, scale_factor,
                                   max_dist, nn_ratio, gate)
    dev = best.device
    P, N = best.shape[0], kp_xy.shape[0]
    build.expect(NAME, dev, (
        ("best_idx", best_idx, torch.int32, (P,)),
        ("best", best, torch.int32, (P,)),
        ("second", second, torch.int32, (P,)),
        ("second_idx", second_idx, torch.int32, (P,)),
        ("row_valid", row_valid, torch.bool, (P,)),
        ("kp_xy", kp_xy, torch.float32, (N, 2)),
        ("kp_octave", kp_octave, torch.int32, (N,)),
        ("kp_ur", kp_ur, torch.float32, (N,))))
    out = _empty(P, dev)
    keys = torch.empty(N, dtype=torch.int64, device=dev)
    ok = torch.empty(P, dtype=torch.bool, device=dev)
    gate_n, gate_min = build.gate_args(gate)
    err = build.library().osl_claim_resolve(
        best_idx.data_ptr(), best.data_ptr(), second.data_ptr(),
        second_idx.data_ptr(), row_valid.data_ptr(), P, kp_xy.data_ptr(),
        kp_ur.data_ptr(), kp_octave.data_ptr(), N,
        scale.table(scale_factor, "sig2", dev).data_ptr(), int(max_dist),
        float(nn_ratio), gate_n, gate_min, keys.data_ptr(), ok.data_ptr(),
        *(t.data_ptr() for t in out), build.stream_handle(dev))
    build.check(err, NAME)
    build.count_launch(__name__)
    return out
