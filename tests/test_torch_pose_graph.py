"""The port's dense essential-graph optimization (kernel P's plain version)
against the JAX package on tests/test_bow_posegraph.py::TestPoseGraph's
graphs, with the reference's own assertions on the port's result, and the
plain blocked factorization of kernel F' against the library's Cholesky."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.ops import geometry as jgeo
from orbslam2_tpu.ops import pose_graph as jpose_graph
from orbslam2_tpu_torch.kernels import ba_solve, ba_solve_blocked, pose_graph
from orbslam2_tpu_torch.ops import geometry as geo
from test_bow_posegraph import _circle_poses

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _centres(S):
    S = _t(S)
    R, t, s = geo.sim3_R(S), geo.sim3_t(S), geo.sim3_s(S)
    return (-(R.transpose(-1, -2) @ t[..., None])[..., 0] / s[:, None]).numpy()


def _angles(Sa, Sb):
    dR = geo.sim3_R(_t(Sa)).transpose(-1, -2) @ geo.sim3_R(_t(Sb))
    return geo.so3_log(dR).norm(dim=1).numpy()


def _drift_graph(rng, K=24):
    """TestPoseGraph.test_corrects_drift's graph, drawn in the same order."""
    S_true = _circle_poses(K)
    ei, ej, Sij = [], [], []
    for k in range(K - 1):
        ei.append(k + 1)
        ej.append(k)
        Sij.append(np.asarray(jgeo.sim3_compose(
            jnp.asarray(S_true[k + 1]), jgeo.sim3_inverse(jnp.asarray(S_true[k])))))
    ei.append(0)
    ej.append(K - 1)
    Sij.append(np.asarray(jgeo.sim3_compose(
        jnp.asarray(S_true[0]), jgeo.sim3_inverse(jnp.asarray(S_true[K - 1])))))
    S_init = [S_true[0]]
    for k in range(K - 1):
        noise = np.zeros(7, np.float32)
        noise[:3] = rng.normal(0, 0.02, 3)
        noise[3:6] = rng.normal(0, 0.01, 3)
        noise[6] = 0.01
        Sd = jgeo.sim3_compose(jnp.asarray(Sij[k]), jnp.asarray(S_init[-1]))
        S_init.append(np.asarray(jgeo.sim3_compose(jgeo.sim3_exp(jnp.asarray(noise)),
                                                   Sd)))
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return (np.stack(S_init), fixed, np.ones(K, bool), np.asarray(ei, np.int32),
            np.asarray(ej, np.int32), np.stack(Sij), np.ones(len(Sij), bool)), S_true


def _fix_scale_graph(rng, K=8):
    """TestPoseGraph.test_fix_scale_mode's graph."""
    S_true = _circle_poses(K)
    ei = np.arange(1, K, dtype=np.int32)
    ej = np.arange(0, K - 1, dtype=np.int32)
    Sij = np.stack([np.asarray(jgeo.sim3_compose(
        jnp.asarray(S_true[k + 1]), jgeo.sim3_inverse(jnp.asarray(S_true[k]))))
        for k in range(K - 1)])
    S_init = S_true.copy()
    S_init[1:, 5:8] += rng.normal(0, 0.05, (K - 1, 3)).astype(np.float32)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return (S_init, fixed, np.ones(K, bool), ei, ej, Sij, np.ones(K - 1, bool)), S_true


@pytest.mark.parametrize("case", ["corrects_drift", "fix_scale_mode"])
def test_pose_graph_matches_reference(case):
    """Camera centres within 1e-3 m and rotations within 1e-3 rad of the
    JAX result (float32 both; the chain prefix is a serial product here and
    an associative scan there, and the dense solve an LU in both), then the
    reference test's assertions on the port's result."""
    rng = np.random.default_rng(0)
    if case == "corrects_drift":
        args, S_true = _drift_graph(rng)
        kw = dict(iters=25)
    else:
        args, S_true = _fix_scale_graph(rng)
        kw = dict(iters=15, fix_scale=True)
    rj = jpose_graph.optimize_pose_graph(*map(jnp.asarray, args), **kw)
    rt = pose_graph.optimize_pose_graph(*map(_t, args), **kw)
    S_j, S_t = np.asarray(rj.poses), rt.poses.numpy()
    assert np.linalg.norm(_centres(S_t) - _centres(S_j), axis=1).max() < 1e-3
    assert _angles(S_t, S_j).max() < 1e-3
    if case == "corrects_drift":
        err_init = np.linalg.norm(_centres(args[0]) - _centres(S_true), axis=1)
        err_opt = np.linalg.norm(_centres(S_t) - _centres(S_true), axis=1)
        assert err_opt.max() < 0.15 * max(err_init.max(), 1e-9)
        np.testing.assert_allclose(S_t[:, 0], 1.0, atol=0.05)
    else:
        np.testing.assert_allclose(S_t[:, 0], 1.0, atol=1e-5)


def test_blocked_cholesky_plain_matches_library():
    """Kernel F' factorises in 32-column panels: its plain version, at
    the circuit's 7K = 455 against torch.linalg.cholesky: the factor within
    1e-4 relative, the solution within 1e-4 relative; a matrix that is not
    positive definite fails."""
    g = torch.Generator().manual_seed(0)
    n = 455
    B = torch.randn(n, n, generator=g)
    A = B @ B.T / n + 0.1 * torch.eye(n)
    b = torch.randn(n, generator=g)
    L, failed = ba_solve_blocked.cholesky_blocked_plain(A)
    L_ref = torch.linalg.cholesky(A)
    assert not bool(failed)
    assert ((L - L_ref).abs().max() / L_ref.abs().max()).item() < 1e-4
    x, _ = ba_solve_blocked.cholesky_solve_blocked(A, b)
    ref = torch.cholesky_solve(b[:, None], L_ref)[:, 0]
    assert ((x - ref).norm() / ref.norm()).item() < 1e-4
    _, failed = ba_solve_blocked.cholesky_blocked_plain(-A)
    assert bool(failed)


def test_blocked_ba_solve_plain_matches_single_block():
    """The BA solve of kernel F' (plain) against kernel F's (plain) on a damped
    reduced camera system of K = 80 cameras, past F's 64: steps within
    1e-4 relative."""
    from orbslam2_tpu_torch.kernels import ba_linearize
    from orbslam2_tpu_torch.models.camera import Camera
    from orbslam2_tpu_torch.ops import ba
    from orbslam2_tpu_torch.utils.synthetic import ba_window

    cam = Camera.create(520.0, 520.0, 320.0, 240.0, bf=52.0)
    prob = ba.BAProblem(*(torch.from_numpy(a) for a in ba_window(80, 1024, 8)))
    lam = torch.full((1,), 1e-4)
    lin = ba_linearize.ba_linearize(cam, prob.poses, prob.points, prob.point_valid,
                                    prob.obs_kf, prob.obs_uvr, prob.obs_sigma2,
                                    prob.obs_valid, lam, True)
    dc_b, _ = ba_solve_blocked.ba_solve_blocked(lin.S, lin.b_S, prob.opt_mask,
                                                lam, prob.poses)
    dc_f, _ = ba_solve.ba_solve(lin.S, lin.b_S, prob.opt_mask, lam, prob.poses)
    assert ((dc_b - dc_f).abs().max() / dc_f.abs().max()).item() < 1e-4
