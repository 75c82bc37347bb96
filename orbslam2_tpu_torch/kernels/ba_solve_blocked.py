"""Kernel F' wrapper: the blocked, multi-block Cholesky factorization and
solve, and bundle adjustment's solve built on it for 6K > 384.

Replaces ``orbslam2_tpu/ops/ba.py``: ``_schur_solve`` (``jnp.linalg.cholesky``
/ ``cho_solve``) and the pose half of ``_apply`` at the global-BA sizes of
``orbslam2_tpu/loop_closing.py:594`` (K up to 256 cameras, 6K = 1536), which
kernel F's single block (6K <= 384) does not reach; kernel P factorises its
(7K)^2 essential-graph system with the same launches. CUDA source:
``csrc/cholesky.cu`` (right-looking, 32-column panels: a one-warp diagonal
factorization, a many-block panel solve and a many-block tiled update of
the trailing lower triangle per panel, then one block for the two
triangular solves; ``cholesky_ba_damp_kernel`` before and
``cholesky_ba_step_kernel`` after, with kernel F's contract). The plain
version factorises in the same panels (``cholesky_blocked_plain``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import build
from .ba_linearize import check_sizes
from .ba_solve import damped_system
from ..ops import geometry as geo

NAME = "ba_solve_blocked"
FUNCTION = "cholesky"  # its factorization's and solve's __global__ functions
SOURCE = "orbslam2_tpu_torch/kernels/csrc/cholesky.cu"
REPLACES = "orbslam2_tpu/ops/ba.py:224"
PANEL = 32
launches = 0


def launches_per_solve(n: int) -> int:
    """Kernel launches of one factorization and solve of n unknowns (a
    BA solve adds its two launches around them)."""
    panels = -(-n // PANEL)
    return 3 * panels - 2 + 1


def cholesky_blocked_plain(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, failed): A = L L^T of the lower triangle of A, factorised in the
    kernel's 32-column panels (diagonal block, the panel below it, the
    trailing update); ``failed`` if a pivot is not > 0."""
    n = A.shape[0]
    L = torch.tril(A).clone()
    failed = torch.zeros((), dtype=torch.bool, device=A.device)
    for J in range(0, n, PANEL):
        w = min(PANEL, n - J)
        D = L[J:J + w, J:J + w]
        Ld, info = torch.linalg.cholesky_ex(D)
        failed = failed | (info > 0) | ~torch.isfinite(Ld).all()
        L[J:J + w, J:J + w] = Ld
        if J + w < n:
            panel = torch.linalg.solve_triangular(
                Ld, L[J + w:, J:J + w].T, upper=False).T
            L[J + w:, J:J + w] = panel
            L[J + w:, J + w:] -= torch.tril(panel @ panel.T)
    return torch.tril(L), failed


def solve_blocked_plain(A: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x, failed) of A x = b by ``cholesky_blocked_plain``."""
    L, failed = cholesky_blocked_plain(A)
    y = torch.linalg.solve_triangular(L, b[:, None], upper=False)
    return torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0], failed


def ba_solve_blocked_plain(S, b_S, opt_mask, lam, poses
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel F's function, factorised in panels: (dc (K, 6), poses_n)."""
    K = opt_mask.shape[0]
    Sd, b, fixedv = damped_system(S, b_S, opt_mask, lam)
    x, failed = solve_blocked_plain(Sd, b)
    dc = torch.where(failed, torch.full_like(x, float("nan")), -x)
    dc = torch.where(fixedv, torch.zeros_like(dc), dc).reshape(K, 6)
    return dc, geo.se3_exp(dc) @ poses


def ba_solve_blocked(S, b_S, opt_mask, lam, poses
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel F' on CUDA tensors, the plain version on CPU tensors."""
    if S.device.type == "cpu":
        return ba_solve_blocked_plain(S, b_S, opt_mask, lam, poses)
    dev = S.device
    K = poses.shape[0]
    check_sizes(NAME, K, 0, 0)
    n = 6 * K
    build.expect(NAME, dev, (
        ("S", S, torch.float32, (n, n)),
        ("b_S", b_S, torch.float32, (n,)),
        ("opt_mask", opt_mask, torch.bool, (K,)),
        ("lam", lam, torch.float32, (1,)),
        ("poses", poses, torch.float32, (K, 4, 4))))
    f32 = dict(dtype=torch.float32, device=dev)
    work = torch.empty((n, n), **f32)
    x = torch.empty(n, **f32)
    failed = torch.empty(1, dtype=torch.int32, device=dev)
    dc = torch.empty((K, 6), **f32)
    poses_n = torch.empty((K, 4, 4), **f32)
    err = build.library().osl_ba_solve_blocked(
        S.data_ptr(), b_S.data_ptr(), opt_mask.data_ptr(), lam.data_ptr(),
        poses.data_ptr(), K, work.data_ptr(), x.data_ptr(), failed.data_ptr(),
        dc.data_ptr(), poses_n.data_ptr(), build.stream_handle(dev))
    build.check(err, NAME)
    build.count_launch(__name__)
    return dc, poses_n


def cholesky_solve_blocked(A: torch.Tensor, b: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x, failed) of A x = b (A's lower triangle, SPD): the launches of F' on
    CUDA tensors (A and b are copied first), the plain version on CPU
    tensors. For tests and timing; on the loop path F' runs inside the BA
    solve and kernel P."""
    if A.device.type == "cpu":
        return solve_blocked_plain(A, b)
    n = A.shape[0]
    build.expect(NAME, A.device, (("A", A, torch.float32, (n, n)),
                                  ("b", b, torch.float32, (n,))))
    L = A.clone()
    x = b.clone()
    failed = torch.empty(1, dtype=torch.int32, device=A.device)
    err = build.library().osl_cholesky_solve_blocked(
        L.data_ptr(), n, x.data_ptr(), failed.data_ptr(),
        build.stream_handle(A.device))
    build.check(err, NAME)
    build.count_launch(__name__)
    return x, failed[0] != 0
