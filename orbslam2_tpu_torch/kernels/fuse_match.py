"""Kernel T wrapper: local mapping's fuse projection search over all
directions at once.

Replaces ``orbslam2_tpu/local_mapping.py``: ``_fuse_match_body`` (vmapped
over the 2N SearchInNeighbors directions by ``_fuse_match_batch`` /
``_fuse_match_mirror``). CUDA source: ``csrc/fuse_match.cu`` (a warp per
(direction, point), the destination's keypoints in shared memory, the
(D, P, N) mask and Hamming matrix never stored; idx, dist and valid
bit-exact against the plain version).

The plain version projects term by term, in the kernel's order, and reads
the radius r sf^octave(kp) from the host's table (``kernels/scale.py``).
"""

from __future__ import annotations

import torch

from . import build, scale
from ..ops import matching

NAME = "fuse_match"
FUNCTION = "fuse_match_kernel"  # the __global__ function it launches
SOURCE = "orbslam2_tpu_torch/kernels/csrc/fuse_match.cu"
REPLACES = "orbslam2_tpu/local_mapping.py:162"
launches = 0
MAX_KEYPOINTS = 4096  # (x, y, r^2) per keypoint in 48 KB of shared memory


def fuse_pairs(mp_pos, mp_valid, Tcw, kp_xy, kp_octave, cam, scale_factor: float,
               radius_mult: float):
    """(rows (D, P), pair (D, P, N)): the points that project in front of
    the keyframe and inside its image, and the pairs inside the radius
    radius_mult * sf^octave(kp) around the projection."""
    X, Y, Z = mp_pos[..., 0], mp_pos[..., 1], mp_pos[..., 2]
    T = Tcw[:, :3, :, None]                                      # (D, 3, 4, 1)
    pc = [T[:, i, 0] * X + T[:, i, 1] * Y + T[:, i, 2] * Z + T[:, i, 3]
          for i in range(3)]
    z = pc[2]
    inv_z = 1.0 / torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)
    u = cam.fx * pc[0] * inv_z + cam.cx
    v = cam.fy * pc[1] * inv_z + cam.cy
    okz = (z > 0.05) & (u >= 0.0) & (u < cam.width) & (v >= 0.0) & (v < cam.height)
    r_px = scale.table(scale_factor, "pow", mp_pos.device,
                       radius_mult)[kp_octave.long()]
    dx = u[:, :, None] - kp_xy[:, None, :, 0]
    dy = v[:, :, None] - kp_xy[:, None, :, 1]
    pair = dx * dx + dy * dy <= (r_px * r_px)[:, None, :]
    return mp_valid & okz, pair


def fuse_match_plain(mp_pos, mp_desc, mp_valid, Tcw, kp_xy, kp_desc, kp_octave,
                     kp_valid, cam, scale_factor: float, radius_mult: float
                     ) -> matching.MatchResult:
    """(D, P, ...) point windows into (D, N, ...) keyframes with poses Tcw
    (D, 4, 4): radius radius_mult * sf^octave(kp), TH_LOW, no ratio test."""
    rows, pair = fuse_pairs(mp_pos, mp_valid, Tcw, kp_xy, kp_octave, cam,
                            scale_factor, radius_mult)
    return matching.match_descriptors(
        mp_desc, kp_desc, rows, kp_valid,
        pair_mask=pair, max_dist=matching.TH_LOW, nn_ratio=1.0,
    )


def fuse_match(mp_pos, mp_desc, mp_valid, Tcw, kp_xy, kp_desc, kp_octave,
               kp_valid, cam, scale_factor: float, radius_mult: float
               ) -> matching.MatchResult:
    """Kernel T on CUDA tensors, the plain version on CPU tensors."""
    if mp_pos.device.type == "cpu":
        return fuse_match_plain(mp_pos, mp_desc, mp_valid, Tcw, kp_xy, kp_desc,
                                kp_octave, kp_valid, cam, scale_factor,
                                radius_mult)
    dev = mp_pos.device
    D, P = mp_pos.shape[:2]
    N = kp_xy.shape[1]
    if N > MAX_KEYPOINTS:
        raise ValueError(f"{NAME}: N={N} keypoints, the kernel takes N <= "
                         f"{MAX_KEYPOINTS}")
    build.expect(NAME, dev, (
        ("mp_pos", mp_pos, torch.float32, (D, P, 3)),
        ("mp_desc", mp_desc, torch.uint8, (D, P, 32)),
        ("mp_valid", mp_valid, torch.bool, (D, P)),
        ("Tcw", Tcw, torch.float32, (D, 4, 4)),
        ("kp_xy", kp_xy, torch.float32, (D, N, 2)),
        ("kp_desc", kp_desc, torch.uint8, (D, N, 32)),
        ("kp_octave", kp_octave, torch.int32, (D, N)),
        ("kp_valid", kp_valid, torch.bool, (D, N))))
    idx = torch.empty((D, P), dtype=torch.int32, device=dev)
    dist = torch.empty((D, P), dtype=torch.int32, device=dev)
    valid = torch.empty((D, P), dtype=torch.bool, device=dev)
    err = build.library().osl_fuse_match(
        mp_pos.data_ptr(), mp_desc.data_ptr(), mp_valid.data_ptr(), Tcw.data_ptr(),
        kp_xy.data_ptr(), kp_desc.data_ptr(), kp_octave.data_ptr(),
        kp_valid.data_ptr(), D, P, N, cam.fx, cam.fy, cam.cx, cam.cy, cam.width,
        cam.height, scale.table(scale_factor, "pow", dev, radius_mult).data_ptr(),
        matching.TH_LOW, idx.data_ptr(), dist.data_ptr(), valid.data_ptr(),
        build.stream_handle(dev))
    build.check(err, NAME)
    build.count_launch(__name__)
    return matching.MatchResult(idx=idx, dist=dist, valid=valid)
