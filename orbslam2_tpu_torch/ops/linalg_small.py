"""Small-matrix linear algebra, unrolled (port of
``orbslam2_tpu.ops.linalg_small``).

The same unrolled Cholesky and adjugate inverse as the reference, so the
6x6 pose solve and the 4x4 triangulation solve round exactly as the
reference's do. All functions broadcast over leading batch dimensions.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form (adjugate) inverse of (..., 3, 3)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co00 = e * i - f * h
    co01 = c * h - b * i
    co02 = b * f - c * e
    co10 = f * g - d * i
    co11 = a * i - c * g
    co12 = c * d - a * f
    co20 = d * h - e * g
    co21 = b * g - a * h
    co22 = a * e - b * d
    det = a * co00 + b * co10 + c * co20
    inv_det = 1.0 / torch.where(det.abs() < _EPS, torch.full_like(det, _EPS), det)
    adj = torch.stack(
        [
            torch.stack([co00, co01, co02], dim=-1),
            torch.stack([co10, co11, co12], dim=-1),
            torch.stack([co20, co21, co22], dim=-1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


def cholesky_small(A: torch.Tensor, n: int) -> torch.Tensor:
    """Unrolled Cholesky of SPD (..., n, n); returns lower L."""
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(s.clamp_min(_EPS))
        inv_ljj = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_ljj
    zero = torch.zeros_like(A[..., 0, 0])
    rows = [
        torch.stack([L[i][j] if j <= i else zero for j in range(n)], dim=-1)
        for i in range(n)
    ]
    return torch.stack(rows, dim=-2)


def solve_spd_small(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve SPD A x = b for (..., n, n), (..., n) with small static n."""
    n = A.shape[-1]
    L = cholesky_small(A, n)
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[..., i, k] * y[k]
        y[i] = s / L[..., i, i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[..., k, i] * x[k]
        x[i] = s / L[..., i, i]
    return torch.stack(x, dim=-1)
