"""Kernel R' wrapper: the pipelined tracker's pose chain on the device.

Replaces the pose algebra of ``orbslam2_tpu/tracking.py``'s
``track_frame_fused_chained`` (:407-411, :417). CUDA source:
``csrc/pose_chain.cu`` (one thread). ``pose_chain(T_a, T_b, motion=True)``
is the motion-model prediction from the two chain links,
orthonormalize(T_a) inv(orthonormalize(T_b)) orthonormalize(T_a);
``pose_chain(T_a)`` is orthonormalize(T_a), the prediction without a motion
model and the next link from kernel R's packed pose. Whether the motion
model holds is decided on the host, so it is a launch argument.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import build
from ..ops import geometry as geo

NAME = "pose_chain"
FUNCTION = "pose_chain_kernel"  # the __global__ function it launches
SOURCE = "orbslam2_tpu_torch/kernels/csrc/pose_chain.cu"
REPLACES = "orbslam2_tpu/tracking.py:407"
launches = 0


def pose_chain_plain(T_a: torch.Tensor, T_b: Optional[torch.Tensor] = None,
                     motion: bool = False) -> torch.Tensor:
    A = geo.se3_orthonormalize(T_a)
    if not motion:
        return A
    vel = A @ geo.se3_inverse(geo.se3_orthonormalize(T_b))
    return vel @ A


def pose_chain(T_a: torch.Tensor, T_b: Optional[torch.Tensor] = None,
               motion: bool = False) -> torch.Tensor:
    """Kernel R' on CUDA tensors, the plain version on CPU tensors: (4, 4)
    float32 links in, the (4, 4) prediction or link out."""
    if T_a.device.type == "cpu":
        return pose_chain_plain(T_a, T_b, motion)
    dev = T_a.device
    if motion and T_b is None:
        raise ValueError(f"{NAME}: the motion model needs the second link")
    links = (("T_a", T_a),) + ((("T_b", T_b),) if motion else ())
    build.expect(NAME, dev, [(k, t, torch.float32, (4, 4)) for k, t in links])
    out = torch.empty((4, 4), dtype=torch.float32, device=dev)
    err = build.library().osl_pose_chain(
        T_a.data_ptr(), (T_b if motion else T_a).data_ptr(), int(motion),
        out.data_ptr(), build.stream_handle(dev))
    build.check(err, NAME)
    build.count_launch(__name__)
    return out
