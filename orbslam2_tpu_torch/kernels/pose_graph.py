"""Kernel P wrapper: the Sim3 essential-graph optimization, dense path.

Replaces ``orbslam2_tpu/ops/pose_graph.py``: ``optimize_pose_graph`` /
``pose_graph_impl`` for K <= 384 vertices (the closed-form start and 20
dense LM iterations); past 384, as the reference, ``optimize_pose_graph``
hands the graph to kernel P' (``kernels/pose_graph_cg.py``, the
matrix-free CG solver). CUDA source: ``csrc/pose_graph.cu`` (a one-block
launch for the start; per iteration the per-edge linearization in dual
numbers, the system's frozen rows and damping, kernel F' blocked
factorization and solve (``csrc/cholesky.cu``), and a one-block update with
the cost test; the state stays on the device). The plain version is
``ops/pose_graph.py`` (``torch.func`` Jacobians, ``torch.linalg.solve``).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import build, pose_graph_cg
from ..ops import pose_graph

NAME = "pose_graph"
FUNCTION = "pose_graph"  # every __global__ function of it holds this name
SOURCE = "orbslam2_tpu_torch/kernels/csrc/pose_graph.cu"
REPLACES = "orbslam2_tpu/ops/pose_graph.py:95"
launches = 0


def workspace_floats(K: int, E: int) -> int:
    """The float workspace csrc/pose_graph.cu lays out: S0, W^-1, M_e, the
    chain links, two correction sets, r0, cost, lam, H (7K)^2 and b."""
    n = 7 * K
    return 8 * K + 8 + 8 * E + 8 * K + 7 * K + 7 * K + 7 * E + 2 + n * n + n


def optimize_pose_graph_plain(S_init, fixed, valid, edge_i, edge_j, edge_Sij,
                              edge_valid, iters: int = 20,
                              fix_scale: bool = False,
                              order: Optional[torch.Tensor] = None,
                              solver: str = "auto"
                              ) -> pose_graph.PoseGraphResult:
    return pose_graph.optimize_pose_graph(S_init, fixed, valid, edge_i, edge_j,
                                          edge_Sij, edge_valid, iters,
                                          fix_scale, order, solver)


def optimize_pose_graph(S_init, fixed, valid, edge_i, edge_j, edge_Sij,
                        edge_valid, iters: int = 20, fix_scale: bool = False,
                        order: Optional[torch.Tensor] = None,
                        solver: str = "auto") -> pose_graph.PoseGraphResult:
    """The plain version on CPU tensors; on CUDA tensors kernel P, or kernel
    P' where the solver is "cg" or, with "auto", K > DENSE_MAX_K (K counts
    every slot, dead ones included, as in the reference)."""
    if S_init.device.type == "cpu":
        return optimize_pose_graph_plain(S_init, fixed, valid, edge_i, edge_j,
                                         edge_Sij, edge_valid, iters, fix_scale,
                                         order, solver)
    dev = S_init.device
    K, E = S_init.shape[0], edge_i.shape[0]
    if solver not in ("auto", "dense", "cg"):
        raise ValueError(f"solver must be auto, dense or cg, got {solver!r}")
    if solver == "cg" or (solver == "auto" and K > pose_graph.DENSE_MAX_K):
        return pose_graph_cg.optimize_pose_graph(S_init, fixed, valid, edge_i,
                                                 edge_j, edge_Sij, edge_valid,
                                                 iters, fix_scale, order)
    if order is None:
        order = torch.arange(K, dtype=torch.int32, device=dev)
    build.expect(NAME, dev, (
        ("S_init", S_init, torch.float32, (K, 8)),
        ("fixed", fixed, torch.bool, (K,)),
        ("valid", valid, torch.bool, (K,)),
        ("edge_i", edge_i, torch.int32, (E,)),
        ("edge_j", edge_j, torch.int32, (E,)),
        ("edge_Sij", edge_Sij, torch.float32, (E, 8)),
        ("edge_valid", edge_valid, torch.bool, (E,)),
        ("order", order, torch.int32, (K,))))
    ws = torch.empty(workspace_floats(K, E), dtype=torch.float32, device=dev)
    # chain positions (K), the failure flag of F', the frozen flags (K bytes)
    iws = torch.empty(K + 1 + (K + 3) // 4, dtype=torch.int32, device=dev)
    out = torch.empty(8 * K + 1, dtype=torch.float32, device=dev)
    err = build.library().osl_pose_graph(
        S_init.data_ptr(), fixed.data_ptr(), valid.data_ptr(), edge_i.data_ptr(),
        edge_j.data_ptr(), edge_Sij.data_ptr(), edge_valid.data_ptr(),
        order.data_ptr(), K, E, int(iters), int(fix_scale), ws.data_ptr(),
        iws.data_ptr(), out.data_ptr(), build.stream_handle(dev))
    build.check(err, NAME)
    build.count_launch(__name__)
    return pose_graph.PoseGraphResult(poses=out[:8 * K].reshape(K, 8),
                                      cost=out[8 * K])
