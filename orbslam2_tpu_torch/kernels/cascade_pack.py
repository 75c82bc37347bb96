"""Kernel R wrapper: the tracking cascade's packed result.

Replaces the tail of ``orbslam2_tpu/tracking.py``: ``_fused_cascade`` (the
choice between the local-map and the tight pass, the close-point census and
the per-point codes). CUDA source: ``csrc/cascade_pack.cu`` (one block; the
packed vector is bit-exact against the plain version).

Packed layout, (20 + P,) float32: Tcw (16), n_motion, n_final,
n_tracked_close, n_untracked_close, then per point
(kp_idx + 1) * 4 + inlier * 2 + frustum.
"""

from __future__ import annotations

import torch

from . import build

NAME = "cascade_pack"
FUNCTION = "cascade_pack_kernel"  # the __global__ function it launches
SOURCE = "orbslam2_tpu_torch/kernels/csrc/cascade_pack.cu"
REPLACES = "orbslam2_tpu/tracking.py:290"
launches = 0
MAX_KEYPOINTS = 32768  # the census keeps a byte per keypoint in shared memory


def cascade_pack_plain(T2, n2, inl2, kp2, T3, n3, inl3, kp3, n_motion, frustum,
                       kp_valid, kp_depth, th_depth: float) -> torch.Tensor:
    use3 = n3 >= n2
    Tcw = torch.where(use3, T3, T2)
    n_final = torch.where(use3, n3, n2)
    inl = torch.where(use3, inl3, inl2)
    kp_of_mp = torch.where(use3, kp3, kp2)

    # close-point census for the keyframe decision (nTrackedClose /
    # nNonTrackedClose)
    N = kp_valid.shape[0]
    tracked_row = inl & (kp_of_mp >= 0)
    kp_tracked = torch.zeros(N + 1, dtype=torch.bool, device=kp_valid.device)
    kp_tracked[torch.where(tracked_row, kp_of_mp.long(),
                           torch.full_like(kp_of_mp.long(), N))] = True
    kp_tracked = kp_tracked[:N]
    close = kp_valid & (kp_depth > 0) & (kp_depth < th_depth)
    n_tracked_close = (close & kp_tracked).sum()
    n_untracked_close = (close & ~kp_tracked).sum()

    code = (kp_of_mp + 1) * 4 + inl.to(torch.int32) * 2 + frustum.to(torch.int32)
    return torch.cat([
        Tcw.reshape(-1),
        torch.stack([n_motion.float(), n_final.float(),
                     n_tracked_close.float(), n_untracked_close.float()]),
        code.float(),
    ])


def cascade_pack(T2, n2, inl2, kp2, T3, n3, inl3, kp3, n_motion, frustum,
                 kp_valid, kp_depth, th_depth: float) -> torch.Tensor:
    """Kernel R on CUDA tensors, the plain version on CPU tensors."""
    if T2.device.type == "cpu":
        return cascade_pack_plain(T2, n2, inl2, kp2, T3, n3, inl3, kp3, n_motion,
                                  frustum, kp_valid, kp_depth, th_depth)
    dev = T2.device
    P, N = kp2.shape[0], kp_valid.shape[0]
    if N > MAX_KEYPOINTS:
        raise ValueError(f"{NAME}: N={N} keypoints, the kernel takes N <= "
                         f"{MAX_KEYPOINTS}")
    build.expect(NAME, dev, (
        ("T2", T2, torch.float32, (4, 4)), ("n2", n2, torch.int32, ()),
        ("inl2", inl2, torch.bool, (P,)), ("kp2", kp2, torch.int32, (P,)),
        ("T3", T3, torch.float32, (4, 4)), ("n3", n3, torch.int32, ()),
        ("inl3", inl3, torch.bool, (P,)), ("kp3", kp3, torch.int32, (P,)),
        ("n_motion", n_motion, torch.int32, ()),
        ("frustum", frustum, torch.bool, (P,)),
        ("kp_valid", kp_valid, torch.bool, (N,)),
        ("kp_depth", kp_depth, torch.float32, (N,))))
    packed = torch.empty(20 + P, dtype=torch.float32, device=dev)
    err = build.library().osl_cascade_pack(
        T2.data_ptr(), n2.data_ptr(), inl2.data_ptr(), kp2.data_ptr(),
        T3.data_ptr(), n3.data_ptr(), inl3.data_ptr(), kp3.data_ptr(),
        n_motion.data_ptr(), frustum.data_ptr(), P, kp_valid.data_ptr(),
        kp_depth.data_ptr(), N, float(th_depth), packed.data_ptr(),
        build.stream_handle(dev))
    build.check(err, NAME)
    build.count_launch(__name__)
    return packed
