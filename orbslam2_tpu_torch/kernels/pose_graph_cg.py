"""Kernel P' wrapper: the Sim3 essential-graph optimization with the
matrix-free preconditioned conjugate-gradient solver.

Replaces ``orbslam2_tpu/ops/pose_graph.py``: ``pose_graph_impl``'s PCG step
(:341-460) with its LM loop, which the reference takes for K > 384
vertices. CUDA source: ``csrc/pose_graph_cg.cu`` (kernel P's start, step and
write-back from ``csrc/pose_graph.cuh``; per LM iteration the per-edge 7x7
blocks, the chain preconditioner's factor and its doubling-scan matrices,
then the whole CG solve in one one-block launch; the (7K)^2 system is
never formed; every sum in a fixed order, each vertex's rows over its
incident edges as the incidence list built here orders them, so a call's
result does not change from run to run). The plain version is
``ops/pose_graph.py`` with ``solver="cg"``.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import build
from ..ops import pose_graph

NAME = "pose_graph_cg"
FUNCTION = "pose_graph"  # every __global__ function of it holds this name
SOURCE = "orbslam2_tpu_torch/kernels/csrc/pose_graph_cg.cu"
REPLACES = "orbslam2_tpu/ops/pose_graph.py:341"
launches = 0
# the CG iterations each LM iteration of the last call took: an int32
# tensor on the card, read without a host sync inside the call
last_cg_iterations: Optional[torch.Tensor] = None
# views of the last call's workspace (``state_views``): its start, its
# corrections and damping after the last LM iteration, and the step that
# iteration solved for
last_state: Optional[dict] = None
EDGE_FLOATS = 3 * 49 + 2 * 7  # an edge's blocks Hii, Hjj, Hij and b_i, b_j


def scan_depth(K: int) -> int:
    """Levels of the doubling scan over K chain positions: 2^d < K."""
    L = 1
    while (1 << L) < K:
        L += 1
    return L


def workspace_floats(K: int, E: int) -> int:
    """The float workspace csrc/pose_graph_cg.cu lays out: kernel P's shared
    part (S0, W^-1, M_e, the chain links, two correction sets, r0, cost,
    lam), the edges' three 7x7 blocks and two gradients, the step b, A^-1
    and B, both scans' levels and seven (K, 7) vectors. O(E + K log K);
    never (7K)^2."""
    shared = 8 * K + 8 + 8 * E + 8 * K + 7 * K + 7 * K + 7 * E + 2
    return (shared + EDGE_FLOATS * E + 7 * K + 2 * 49 * K
            + 2 * scan_depth(K) * 49 * K + 7 * 7 * K)


def state_views(ws: torch.Tensor, K: int, E: int) -> dict:
    """Views of a workspace after a call: the recentred base ``S0`` (K, 8),
    the base-relative edge transforms ``M_e`` (E, 8), the corrections ``x``
    (K, 7) and the damping ``lam`` after the last LM iteration, and the
    ``step`` v (K, 7) that iteration solved (H + lam I) v = b for (its x
    and lam are those a call with one LM iteration fewer ends with)."""
    parts = (("S0", 8 * K), ("W_inv", 8), ("M_e", 8 * E), ("links", 8 * K),
             ("x_trial", 7 * K), ("x", 7 * K), ("r0", 7 * E), ("cost", 1),
             ("lam", 1), ("edges", EDGE_FLOATS * E), ("step", 7 * K))
    views, at = {}, 0
    for name, size in parts:
        views[name] = ws[at:at + size]
        at += size
    return dict(S0=views["S0"].view(K, 8), M_e=views["M_e"].view(E, 8),
                x=views["x"].view(K, 7), lam=views["lam"][0],
                step=views["step"].view(K, 7))


def incidence(edge_i: torch.Tensor, edge_j: torch.Tensor, K: int):
    """Each vertex's edge ends, in a fixed order: (ptr (K + 1,), inc (2E,)),
    inc[ptr[v]:ptr[v + 1]] holding e where v is edge e's i end and E + e
    where it is its j end, by edge within each end kind (a stable sort)."""
    ends = torch.cat([edge_i, edge_j]).long()
    key, inc = torch.sort(ends, stable=True)
    ptr = torch.searchsorted(key, torch.arange(K + 1, device=ends.device))
    return ptr.to(torch.int32), inc.to(torch.int32)


def launches_per_iteration(K: int) -> int:
    """Kernel launches of one LM iteration (linearize, chain, maps, the
    scan levels past the first, the CG solve, the update), whatever the
    number of CG iterations."""
    return 5 + scan_depth(K) - 1


def optimize_pose_graph_plain(S_init, fixed, valid, edge_i, edge_j, edge_Sij,
                              edge_valid, iters: int = 20,
                              fix_scale: bool = False,
                              order: Optional[torch.Tensor] = None,
                              max_cg: Optional[int] = None
                              ) -> pose_graph.PoseGraphResult:
    return pose_graph.optimize_pose_graph(S_init, fixed, valid, edge_i, edge_j,
                                          edge_Sij, edge_valid, iters, fix_scale,
                                          order, solver="cg", max_cg=max_cg)


def optimize_pose_graph(S_init, fixed, valid, edge_i, edge_j, edge_Sij,
                        edge_valid, iters: int = 20, fix_scale: bool = False,
                        order: Optional[torch.Tensor] = None,
                        max_cg: Optional[int] = None
                        ) -> pose_graph.PoseGraphResult:
    """Kernel P' on CUDA tensors, the plain CG version on CPU tensors.
    ``max_cg`` caps each CG solve below the reference's min(K, 600)
    iterations (to hold a truncated solve against the plain version)."""
    global launches, last_cg_iterations, last_state
    if S_init.device.type == "cpu":
        return optimize_pose_graph_plain(S_init, fixed, valid, edge_i, edge_j,
                                         edge_Sij, edge_valid, iters, fix_scale,
                                         order, max_cg)
    dev = S_init.device
    K, E = S_init.shape[0], edge_i.shape[0]
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
    inc_ptr, inc = incidence(edge_i, edge_j, K)
    ws = torch.empty(workspace_floats(K, E), dtype=torch.float32, device=dev)
    # chain positions (K), the failure flag, the frozen flags (K bytes), the
    # CG iterations of each LM iteration
    n_flags = K + 1 + (K + 3) // 4
    iws = torch.empty(n_flags + iters, dtype=torch.int32, device=dev)
    out = torch.empty(8 * K + 1, dtype=torch.float32, device=dev)
    err = build.library().osl_pose_graph_cg(
        S_init.data_ptr(), fixed.data_ptr(), valid.data_ptr(), edge_i.data_ptr(),
        edge_j.data_ptr(), edge_Sij.data_ptr(), edge_valid.data_ptr(),
        order.data_ptr(), inc_ptr.data_ptr(), inc.data_ptr(), K, E, int(iters),
        int(fix_scale), int(max_cg or 0), ws.data_ptr(), iws.data_ptr(),
        out.data_ptr(), build.stream_handle(dev))
    build.check(err, NAME)
    launches += 1
    last_cg_iterations = iws[n_flags:]
    last_state = state_views(ws, K, E)
    return pose_graph.PoseGraphResult(poses=out[:8 * K].reshape(K, 8),
                                      cost=out[8 * K])
