"""Kernel F wrapper: the damped Cholesky solve of the reduced camera system
and the pose update.

Replaces ``orbslam2_tpu/ops/ba.py``: ``_schur_solve`` (with the dense
``jnp.linalg.cholesky`` / ``cho_solve``) and the pose half of ``_apply``.
CUDA source: ``csrc/ba.cu`` (``ba_solve_kernel``: one block; a blocked
Cholesky of the 6K x 6K system in a device workspace).

Rows and columns of fixed cameras are replaced by the identity, each
camera block is damped by lam times its mean diagonal, the system is made
exactly symmetric, factorised and solved for dc = -S^-1 b_S, and
poses_n = se3_exp(dc) @ poses. A non-positive pivot gives NaN steps for the
optimised cameras, which the cost test then rejects.

Kernel F holds the system in one block's reach, 6K <= 384 (K <= 64); past
that ``ba_solve`` hands the same function to kernel F'
(``kernels/ba_solve_blocked.py``), the multi-block factorization.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import build
from .ba_linearize import check_sizes
from ..ops import geometry as geo

NAME = "ba_solve"
FUNCTION = "ba_solve_kernel"  # the __global__ function it launches
SOURCE = "orbslam2_tpu_torch/kernels/csrc/ba.cu"
REPLACES = "orbslam2_tpu/ops/ba.py:224"
launches = 0
MAX_SINGLE_K = 64  # 6K <= kMaxN = 384 in csrc/ba.cu


def damped_system(S, b_S, opt_mask, lam):
    """(Sd, b_S, fixedv): the system kernel F factorises, with the rows and
    columns of fixed cameras replaced by the identity, each camera block
    damped by lam times its mean diagonal, exactly symmetric."""
    K = opt_mask.shape[0]
    fixedv = (~opt_mask).repeat_interleave(6)
    keep = (~fixedv[:, None]) & (~fixedv[None, :])
    S = torch.where(keep, S, torch.zeros_like(S)) + torch.diag(fixedv.to(S.dtype))
    b_S = torch.where(fixedv, torch.zeros_like(b_S), b_S)
    tr_k = torch.diagonal(S).reshape(K, 6).mean(1)
    add = lam * tr_k.clamp_min(1e-6)
    Sd = S + torch.diag(add.repeat_interleave(6))
    return 0.5 * (Sd + Sd.T), b_S, fixedv


def ba_solve_plain(S, b_S, opt_mask, lam, poses) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dc (K, 6), poses_n (K, 4, 4))."""
    K = opt_mask.shape[0]
    Sd, b_S, fixedv = damped_system(S, b_S, opt_mask, lam)
    # cholesky_ex neither raises nor synchronises; a failed factorization
    # yields NaN steps, which the cost test rejects (as the reference's NaN
    # Cholesky does)
    L, info = torch.linalg.cholesky_ex(Sd)
    dc = -torch.cholesky_solve(b_S[:, None], L)[:, 0]
    dc = torch.where(info > 0, torch.full_like(dc, float("nan")), dc)
    dc = torch.where(fixedv, torch.zeros_like(dc), dc).reshape(K, 6)
    return dc, geo.se3_exp(dc) @ poses


def ba_solve(S, b_S, opt_mask, lam, poses) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel F on CUDA tensors (kernel F' past K = 64), the plain version
    on CPU tensors."""
    if S.device.type == "cpu":
        return ba_solve_plain(S, b_S, opt_mask, lam, poses)
    dev = S.device
    K = poses.shape[0]
    check_sizes(NAME, K, 0, 0)
    if K > MAX_SINGLE_K:
        from . import ba_solve_blocked

        return ba_solve_blocked.ba_solve_blocked(S, b_S, opt_mask, lam, poses)
    n = 6 * K
    build.expect(NAME, dev, (
        ("S", S, torch.float32, (n, n)),
        ("b_S", b_S, torch.float32, (n,)),
        ("opt_mask", opt_mask, torch.bool, (K,)),
        ("lam", lam, torch.float32, (1,)),
        ("poses", poses, torch.float32, (K, 4, 4))))
    dc = torch.empty((K, 6), dtype=torch.float32, device=dev)
    poses_n = torch.empty((K, 4, 4), dtype=torch.float32, device=dev)
    work = torch.empty((n, n), dtype=torch.float32, device=dev)
    err = build.library().osl_ba_solve(
        S.data_ptr(), b_S.data_ptr(), opt_mask.data_ptr(), lam.data_ptr(),
        poses.data_ptr(), K, work.data_ptr(),
        dc.data_ptr(), poses_n.data_ptr(), build.stream_handle(dev))
    build.check(err, NAME)
    build.count_launch(__name__)
    return dc, poses_n
