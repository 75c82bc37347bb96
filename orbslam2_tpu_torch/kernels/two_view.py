"""Kernel X wrapper: the monocular two-view initializer.

Replaces ``orbslam2_tpu/ops/initializer.py``: ``initialize_two_view``. CUDA
source: ``csrc/two_view.cu``, four launches, one per stage of
``ops/initializer.py`` (X1 ``hypotheses``: a block per H or F hypothesis,
Jacobi eigen-solves in double, the block's score; X2 ``refine``: the
winners' all-inlier refits, the model choice and the decomposition; X3
``check_hypotheses``: ``check_rt`` a block per candidate pose; X4
``select``: the gates, and the result packed for one copy). Both the
kernel and the plain version return the packed result

    [success, used_homography, T21 (16), points3d (3N), good (N)]

as one (18 + 4N,) float32 tensor; ``unpack`` reads it on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import build
from ..ops import initializer

NAME = "two_view"
FUNCTION = "two_view"  # its four __global__ functions hold this name
SOURCE = "orbslam2_tpu_torch/kernels/csrc/two_view.cu"
REPLACES = "orbslam2_tpu/ops/initializer.py:294"
MAX_N = 8192  # correspondences the check keeps in shared memory
launches = 0

N_HYP = 2 * initializer.N_ITERS
N_CAND = 8


def pack(res: initializer.InitResult) -> torch.Tensor:
    f = torch.float32
    return torch.cat([res.success.to(f).reshape(1), res.used_homography.to(f).reshape(1),
                      res.T21.reshape(-1).to(f), res.points3d.reshape(-1).to(f),
                      res.good.to(f)])


def unpack(packed: np.ndarray, n: int) -> initializer.InitResult:
    """The packed result (host array) as an InitResult of numpy arrays."""
    p = np.asarray(packed)
    return initializer.InitResult(
        success=bool(p[0] > 0.5), used_homography=bool(p[1] > 0.5),
        T21=p[2:18].reshape(4, 4).astype(np.float32),
        points3d=p[18:18 + 3 * n].reshape(n, 3).astype(np.float32),
        good=p[18 + 3 * n:18 + 4 * n] > 0.5)


def two_view_plain(x1, x2, valid, K, samples) -> torch.Tensor:
    K = torch.as_tensor(K, dtype=torch.float32).to(x1.device)
    return pack(initializer.initialize_two_view(x1, x2, valid, K, samples))


class Stages(NamedTuple):
    """Kernel X's intermediate buffers on the device."""
    hyp: torch.Tensor       # (400, 9): H21 of hypotheses 0-199, F21 of 200-399
    scores: torch.Tensor    # (400,)
    cand: torch.Tensor      # (8, 12): R (row-major) and t of each candidate
    meta: torch.Tensor      # (31,): use_h, SH, SF, best_h, best_f, mask (8), H, F
    X: torch.Tensor         # (8, N, 3)
    good: torch.Tensor      # (8, N) bool
    n_good: torch.Tensor    # (8,) int32, -1 where masked
    parallax: torch.Tensor  # (8,)
    out: torch.Tensor       # (18 + 4N,) the packed result


def _check(x1, x2, valid, K, samples):
    dev = x1.device
    N = x1.shape[0]
    if not 0 < N <= MAX_N:
        raise ValueError(f"{NAME}: N={N} outside 1..{MAX_N}")
    build.expect(NAME, dev, (
        ("x1", x1, torch.float32, (N, 2)), ("x2", x2, torch.float32, (N, 2)),
        ("valid", valid, torch.bool, (N,)),
        ("samples", samples, torch.int32, (initializer.N_ITERS, 8))))
    k = np.asarray(K.detach().cpu() if torch.is_tensor(K) else K, np.float64)
    if k.shape != (3, 3):
        raise ValueError(f"{NAME}: K must be (3, 3)")
    return N, (float(k[0, 0]), float(k[1, 1]), float(k[0, 2]), float(k[1, 2]))


def stages(x1, x2, valid, K, samples, first: int = 1, upto: int = 4,
           given: "Stages" = None) -> Stages:
    """Launches X``first``..X``upto`` on CUDA tensors into ``given``'s
    buffers (new ones without), so a test can feed a launch the plain
    version's intermediate output in place of the earlier launches'."""
    dev = x1.device
    N, (fx, fy, cx, cy) = _check(x1, x2, valid, K, samples)
    st = given or Stages(
        torch.empty((N_HYP, 9), dtype=torch.float32, device=dev),
        torch.empty(N_HYP, dtype=torch.float32, device=dev),
        torch.empty((N_CAND, 12), dtype=torch.float32, device=dev),
        torch.empty(31, dtype=torch.float32, device=dev),
        torch.empty((N_CAND, N, 3), dtype=torch.float32, device=dev),
        torch.empty((N_CAND, N), dtype=torch.bool, device=dev),
        torch.empty(N_CAND, dtype=torch.int32, device=dev),
        torch.empty(N_CAND, dtype=torch.float32, device=dev),
        torch.empty(18 + 4 * N, dtype=torch.float32, device=dev))
    lib = build.library()
    s = build.stream_handle(dev)
    if first <= 1 <= upto:
        build.check(lib.osl_two_view_hypotheses(
            x1.data_ptr(), x2.data_ptr(), valid.data_ptr(), N, samples.data_ptr(),
            st.hyp.data_ptr(), st.scores.data_ptr(), s), NAME)
    if first <= 2 <= upto:
        build.check(lib.osl_two_view_refine(
            x1.data_ptr(), x2.data_ptr(), valid.data_ptr(), N, st.hyp.data_ptr(),
            st.scores.data_ptr(), fx, fy, cx, cy, st.cand.data_ptr(),
            st.meta.data_ptr(), s), NAME)
    if first <= 3 <= upto:
        build.check(lib.osl_two_view_check(
            x1.data_ptr(), x2.data_ptr(), valid.data_ptr(), N, fx, fy, cx, cy,
            st.cand.data_ptr(), st.meta.data_ptr(), st.X.data_ptr(),
            st.good.data_ptr(), st.n_good.data_ptr(), st.parallax.data_ptr(), s),
            NAME)
    if first <= 4 <= upto:
        build.check(lib.osl_two_view_select(
            valid.data_ptr(), N, st.cand.data_ptr(), st.meta.data_ptr(),
            st.X.data_ptr(), st.good.data_ptr(), st.n_good.data_ptr(),
            st.parallax.data_ptr(), st.out.data_ptr(), s), NAME)
    return st


def two_view(x1, x2, valid, K, samples) -> torch.Tensor:
    """Kernel X on CUDA tensors, the plain version on CPU tensors; returns
    the packed result. ``K`` (3, 3) may be a host array (the kernel takes
    fx, fy, cx, cy as arguments)."""
    if x1.device.type == "cpu":
        return two_view_plain(x1, x2, valid, K, samples)
    out = stages(x1, x2, valid, K, samples).out
    build.count_launch(__name__)
    return out
