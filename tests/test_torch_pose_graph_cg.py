"""The port's matrix-free CG essential graph (kernel P''s plain version,
``ops/pose_graph.py`` with ``solver="cg"``) against the JAX package on
tests/test_bow_posegraph.py::test_cg_matches_dense's graph, and the
preconditioner's doubling scan against a sequential float64 recurrence.
(tests/test_torch_pose_graph_auto.py holds the comparison past the dense
limit: each JAX compile of the CG program takes about a minute on the
CPU.)"""

import jax.numpy as jnp
import numpy as np
import torch

from orbslam2_tpu.ops import geometry as jgeo
from orbslam2_tpu.ops import pose_graph as jpose_graph
from orbslam2_tpu_torch.kernels import pose_graph, pose_graph_cg
from orbslam2_tpu_torch.ops import pose_graph as pg_ops
from orbslam2_tpu_torch.utils.synthetic import pose_graph_ring
from test_bow_posegraph import _circle_poses

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cg_dense_graph(rng, K=24):
    """TestPoseGraph.test_cg_matches_dense's graph, drawn in the same order."""
    S_true = _circle_poses(K)
    ei = list(range(1, K)) + [0]
    ej = list(range(0, K - 1)) + [K - 1]
    Sij = [np.asarray(jgeo.sim3_compose(
        jnp.asarray(S_true[i]), jgeo.sim3_inverse(jnp.asarray(S_true[j]))))
        for i, j in zip(ei, ej)]
    S_init = S_true.copy()
    S_init[1:, 5:8] += rng.normal(0, 0.05, (K - 1, 3)).astype(np.float32)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return (S_init, fixed, np.ones(K, bool), np.asarray(ei, np.int32),
            np.asarray(ej, np.int32), np.stack(Sij), np.ones(K, bool))


def test_cg_matches_reference_and_dense():
    """K = 24, 15 iterations: the port's plain CG within 1e-5 of the JAX
    CG's pose vectors (measured 1.4e-6: float32 both, the chain scan a
    doubling scan here and jax.lax.associative_scan there), and, as the
    reference test holds its CG, within 2e-3 of the port's dense solver
    (measured 1.9e-6)."""
    args = _cg_dense_graph(np.random.default_rng(0))
    rj = jpose_graph.optimize_pose_graph(*map(jnp.asarray, args), iters=15,
                                         solver="cg")
    rc = pose_graph.optimize_pose_graph(*map(_t, args), iters=15, solver="cg")
    rd = pose_graph.optimize_pose_graph(*map(_t, args), iters=15, solver="dense")
    np.testing.assert_allclose(rc.poses.numpy(), np.asarray(rj.poses), atol=1e-5)
    np.testing.assert_allclose(rc.poses.numpy(), rd.poses.numpy(), atol=2e-3)


def test_doubling_scan_matches_sequential_recurrence():
    """x_k = M_k x_{k-1} + c_k over K = 2000 positions (11 levels) with
    random near-orthogonal 7x7 maps, as the chain's Sim3 adjoints are: the
    float32 doubling scan within 1e-5 of the float64 sequential recurrence,
    relative to its largest value (measured 2.6e-7), the same for the
    reversed scan the preconditioner's backward pass runs."""
    rng = np.random.default_rng(0)
    K = 2000
    Q, _ = np.linalg.qr(rng.normal(size=(K, 7, 7)))
    M = Q * rng.uniform(0.9, 1.0, (K, 1, 1))
    c = rng.normal(size=(K, 7))
    x = np.zeros(7)
    ref = []
    for k in range(K):
        x = M[k] @ x + c[k]
        ref.append(x)
    ref = np.stack(ref)
    levels = pg_ops.scan_levels(torch.from_numpy(M).float())
    assert len(levels) == 11
    out = pg_ops.affine_scan(levels, torch.from_numpy(c).float()).double().numpy()
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-5
    back = pg_ops.affine_scan(pg_ops.scan_levels(torch.from_numpy(M[::-1].copy()).float()),
                              torch.from_numpy(c[::-1].copy()).float())
    x = np.zeros(7)
    for k in reversed(range(K)):
        x = M[k] @ x + c[k]
    assert np.abs(back[-1].double().numpy() - x).max() / np.abs(x).max() < 1e-5


def test_matvec_matches_dense_system():
    """The CG's matrix-free product (H + lam I) v from the edges' block
    pairs equals the dense normal equations' product on a drifted
    30-keyframe ring with one edge invalid (1e-5 relative to the largest
    entry), for v zero on the frozen rows as every CG vector is there (the
    dense system also zeroes the frozen vertices' columns)."""
    args, _ = pose_graph_ring(30)
    S, fixed, valid, ei, ej, Sij, ev = args
    ev = ev.clone()
    ev[3] = False
    x, _, _, M_e, freeze, _ = pg_ops.prepare(S, fixed, valid, ei, ej, Sij, ev)
    lam = torch.tensor(1e-3)
    Hii, Hjj, Hij, _ = pg_ops.edge_blocks(x, ei, ej, M_e, Sij, ev, freeze)
    H, _ = pg_ops.normal_equations(x, lam, ei, ej, M_e, Sij, ev, freeze)
    v = torch.from_numpy(np.random.default_rng(1).normal(size=(30, 7))).float()
    v[freeze] = 0.0
    got = pg_ops.matvec(pg_ops.pair_blocks(Hii, Hjj, Hij), v, ei, ej, lam, freeze)
    want = (H @ v.reshape(-1)).reshape(30, 7)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_max_cg_caps_each_solve():
    """``max_cg`` caps every LM iteration's CG solve (the plain version as
    kernel P' takes it); the capped run never raises the cost."""
    args, _ = pose_graph_ring(30)
    calls = []
    solve = pg_ops.cg_solve

    def counted(*a, **k):
        v, n = solve(*a, **k)
        calls.append(n)
        return v, n

    pg_ops.cg_solve = counted
    try:
        r = pose_graph_cg.optimize_pose_graph(*args, iters=5, fix_scale=True,
                                              max_cg=2)
    finally:
        pg_ops.cg_solve = solve
    assert calls == [2] * 5
    r0 = pose_graph_cg.optimize_pose_graph(*args, iters=0, fix_scale=True)
    assert torch.isfinite(r.poses).all() and r.cost <= r0.cost


def test_incidence_lists_each_vertex_edge_ends_in_order():
    """Kernel P''s incidence list: vertex v's run holds e where v is edge
    e's i end and E + e where it is its j end, the i ends first, each by
    edge, so every row sum of b and of the matvec adds the same terms in
    the same order on every call."""
    rng = np.random.default_rng(3)
    K, E = 12, 40
    ei = torch.from_numpy(rng.integers(0, K, E).astype(np.int32))
    ej = torch.from_numpy(rng.integers(0, K, E).astype(np.int32))
    ptr, inc = pose_graph_cg.incidence(ei, ej, K)
    assert ptr.dtype == inc.dtype == torch.int32
    assert ptr[0] == 0 and ptr[-1] == 2 * E
    for v in range(K):
        run = inc[ptr[v]:ptr[v + 1]].tolist()
        want = ([e for e in range(E) if ei[e] == v]
                + [E + e for e in range(E) if ej[e] == v])
        assert run == want
