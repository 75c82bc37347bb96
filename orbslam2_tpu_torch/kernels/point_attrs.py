"""Kernel N wrapper: batched map-point attributes.

Replaces ``orbslam2_tpu/ops/point_attrs.py:29`` (``point_attributes``): per
point over its observation slots, the distinctive descriptor (the
observation with the lowest median Hamming distance to the others,
MapPoint::ComputeDistinctiveDescriptors), the mean viewing normal and the
scale-invariance band from the reference-keyframe observation
(MapPoint::UpdateNormalAndDepth), reading the device keyframe mirror. CUDA
source: ``csrc/point_attrs.cu`` (one block per point, one thread per slot,
any slot bucket up to the observation table's width). Descriptors and reference keyframes are exact against
``point_attributes_plain``; the normal and the band are float32 sums in
another order.
"""

from __future__ import annotations

import torch

from . import build
from ..ops.matching import unpack_bits

NAME = "point_attrs"
FUNCTION = "point_attrs_kernel"  # the __global__ function it launches
SOURCE = "orbslam2_tpu_torch/kernels/csrc/point_attrs.cu"
REPLACES = "orbslam2_tpu/ops/point_attrs.py:29"
launches = 0

BIG = 10000
MAX_SLOTS = 1024   # one thread per observation slot, a block's limit


def point_attributes_plain(kf_desc, kf_octave, kf_pose, obs_kf, obs_ft, mp_pos,
                           mp_ref_kf, scale_factor: float,
                           n_levels_m1: float) -> torch.Tensor:
    """Packed (P, 38) f32: desc (32, as floats), normal (3), dmin, dmax,
    ref_kf. Rows with no valid observation carry garbage the caller masks."""
    obs_kf = obs_kf.long()
    obs_ft = obs_ft.long()
    P, O = obs_kf.shape
    sel = obs_kf >= 0
    kfs = obs_kf.clamp_min(0)
    fts = obs_ft.clamp_min(0)

    # distinctive descriptor: min median pairwise Hamming
    descs = kf_desc[kfs, fts]                                   # (P, O, 32)
    bitsf = unpack_bits(descs).float()                         # (P, O, 256)
    G = bitsf @ bitsf.transpose(1, 2)                           # (P, O, O)
    s = bitsf.sum(-1)
    dm = (s[:, :, None] + s[:, None, :] - 2.0 * G).to(torch.int32)
    both = sel[:, :, None] & sel[:, None, :]
    dm = torch.where(both, dm, torch.full_like(dm, BIG))
    dm_sorted = dm.sort(dim=2).values
    n_obs = sel.sum(1)
    med_idx = ((n_obs - 1) // 2).clamp_min(0)
    med = dm_sorted.gather(2, med_idx[:, None, None].expand(P, O, 1))[:, :, 0]
    med = torch.where(sel, med, torch.full_like(med, BIG))
    best = med.argmin(1)
    out_desc = descs[torch.arange(P, device=descs.device), best]

    # mean viewing normal from the per-keyframe camera centres
    Rk = kf_pose[:, :3, :3]
    tk = kf_pose[:, :3, 3]
    centers_k = -torch.einsum("kji,kj->ki", Rk, tk)             # -R^T t
    vec = mp_pos[:, None, :] - centers_k[kfs]                   # (P, O, 3)
    vlen = torch.sqrt((vec[..., 0] * vec[..., 0] + vec[..., 1] * vec[..., 1]
                       + vec[..., 2] * vec[..., 2]).clamp_min(1e-18))
    selw = torch.where(sel, 1.0 / vlen, torch.zeros_like(vlen))
    n = (vec * selw[..., None]).sum(1)
    n = n / n_obs.clamp_min(1)[:, None]
    out_normal = n / torch.linalg.norm(n, dim=1, keepdim=True).clamp_min(1e-9)

    # scale band from the reference-KF observation (else the first live one)
    is_ref = sel & (obs_kf == mp_ref_kf.long()[:, None])
    has_ref = is_ref.any(1)
    j = torch.where(has_ref, is_ref.to(torch.uint8).argmax(1),
                    sel.to(torch.uint8).argmax(1))
    out_ref = obs_kf.gather(1, j[:, None])[:, 0]
    dist = vlen.gather(1, j[:, None])[:, 0]
    kj = kfs.gather(1, j[:, None])[:, 0]
    fj = fts.gather(1, j[:, None])[:, 0]
    level = kf_octave[kj, fj].float()
    sf = torch.tensor(scale_factor, dtype=torch.float32, device=dist.device)
    dmax = dist * torch.pow(sf, level)
    dmin = dmax / torch.pow(sf, n_levels_m1)
    return torch.cat([
        out_desc.float(), out_normal, dmin[:, None], dmax[:, None],
        out_ref.float()[:, None],
    ], dim=1)


def point_attributes(kf_desc, kf_octave, kf_pose, obs_kf, obs_ft, mp_pos,
                     mp_ref_kf, scale_factor: float, n_levels_m1: float) -> torch.Tensor:
    """Kernel N on CUDA tensors (observation slots as int16, 1 <= O <=
    MAX_SLOTS), the plain version on CPU tensors."""
    if obs_kf.device.type == "cpu":
        return point_attributes_plain(kf_desc, kf_octave, kf_pose, obs_kf, obs_ft,
                                      mp_pos, mp_ref_kf, scale_factor, n_levels_m1)
    dev = obs_kf.device
    P, O = obs_kf.shape
    Kc, n_feat = kf_octave.shape
    if not 1 <= O <= MAX_SLOTS:
        raise ValueError(f"{NAME}: O={O} slots, want 1..{MAX_SLOTS} (a thread each)")
    build.expect(NAME, dev, [("kf_desc", kf_desc, torch.uint8, (Kc, n_feat, 32)),
                             ("kf_octave", kf_octave, torch.int32, (Kc, n_feat)),
                             ("kf_pose", kf_pose, torch.float32, (Kc, 4, 4)),
                             ("obs_kf", obs_kf, torch.int16, (P, O)),
                             ("obs_ft", obs_ft, torch.int16, (P, O)),
                             ("mp_pos", mp_pos, torch.float32, (P, 3)),
                             ("mp_ref_kf", mp_ref_kf, torch.int32, (P,))])
    out = torch.empty((P, 38), dtype=torch.float32, device=dev)
    err = build.library().osl_point_attrs(
        kf_desc.data_ptr(), kf_octave.data_ptr(), kf_pose.data_ptr(), n_feat,
        obs_kf.data_ptr(), obs_ft.data_ptr(), mp_pos.data_ptr(),
        mp_ref_kf.data_ptr(), P, O, float(scale_factor), float(n_levels_m1),
        out.data_ptr(), build.stream_handle(dev))
    build.check(err, NAME)
    build.count_launch(__name__)
    return out
