"""The port's Sim(3) group, Sim3 RANSAC (kernel K's plain version),
OptimizeSim3 and SearchBySim3 (kernel M's) against the JAX package on the
reference tests' scenes (tests/test_solvers.py::TestSim3,
tests/test_sim3_opt.py), the same seeded inputs through both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.models.camera import Camera as JCamera
from orbslam2_tpu.ops import geometry as jgeo
from orbslam2_tpu.ops import sim3_opt as jsim3_opt
from orbslam2_tpu.ops import sim3_solver as jsim3_solver
from orbslam2_tpu_torch.kernels import sim3_opt, sim3_ransac, sim3_search
from orbslam2_tpu_torch.models.camera import Camera
from orbslam2_tpu_torch.ops import geometry as geo
from test_sim3_opt import _problem as sim3_opt_problem

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def tangents():
    """Sim(3) tangents: generic, near-zero angle, near-zero sigma, both."""
    rng = np.random.default_rng(0)
    xi = rng.normal(0, 0.4, (64, 7)).astype(np.float32)
    xi[:8, 3:6] *= 1e-7
    xi[8:16, 6] = 0.0
    xi[16:20] *= 1e-7
    return xi


class TestSim3Group:
    """Within 1e-5 of orbslam2_tpu/ops/geometry.py (float32 both)."""

    def test_exp_log(self, tangents):
        S_j = np.asarray(jgeo.sim3_exp(jnp.asarray(tangents)))
        S_t = geo.sim3_exp(_t(tangents)).numpy()
        np.testing.assert_allclose(S_t, S_j, atol=1e-5)
        np.testing.assert_allclose(geo.sim3_log(_t(S_j)).numpy(),
                                   np.asarray(jgeo.sim3_log(jnp.asarray(S_j))),
                                   atol=1e-5)
        # round trip
        np.testing.assert_allclose(geo.sim3_log(geo.sim3_exp(_t(tangents))).numpy(),
                                   tangents, atol=1e-5)

    def test_compose_inverse_apply(self, tangents):
        S = np.asarray(jgeo.sim3_exp(jnp.asarray(tangents)))
        A, B = S[:32], S[32:]
        np.testing.assert_allclose(
            geo.sim3_compose(_t(A), _t(B)).numpy(),
            np.asarray(jgeo.sim3_compose(jnp.asarray(A), jnp.asarray(B))), atol=1e-5)
        np.testing.assert_allclose(
            geo.sim3_inverse(_t(A)).numpy(),
            np.asarray(jgeo.sim3_inverse(jnp.asarray(A))), atol=1e-5)
        p = np.random.default_rng(1).normal(0, 3, (32, 3)).astype(np.float32)
        np.testing.assert_allclose(
            geo.sim3_apply(_t(A), _t(p)).numpy(),
            np.asarray(jgeo.sim3_apply(jnp.asarray(A), jnp.asarray(p))), atol=1e-5)
        T = np.asarray(jgeo.se3_from_sim3(jnp.asarray(A)))
        np.testing.assert_allclose(geo.se3_from_sim3(_t(A)).numpy(), T, atol=1e-5)
        np.testing.assert_allclose(geo.sim3_from_se3(_t(T)).numpy(),
                                   np.asarray(jgeo.sim3_from_se3(jnp.asarray(T))),
                                   atol=1e-5)


def _ransac_scene(rng, n=60, fix_scale=False, noise=0.002, outlier_frac=0.0):
    """tests/test_solvers.py::TestSim3._problem, drawn in the same order."""
    p1 = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                   rng.uniform(4, 9, n)], axis=1).astype(np.float32)
    R = np.asarray(jgeo.so3_exp(jnp.asarray([0.1, 0.2, -0.05]))).astype(np.float32)
    t = np.array([0.4, -0.3, 0.2], np.float32)
    s = 1.0 if fix_scale else 1.4
    p2 = ((p1 - t) / s) @ R
    p2 = (p2 + rng.normal(0, noise, p2.shape)).astype(np.float32)
    n_out = int(outlier_frac * n)
    p2[:n_out] += rng.uniform(0.5, 1.5, (n_out, 3)).astype(np.float32)
    return p1, p2, s, n_out


@pytest.mark.parametrize("case,n_samples,fix_scale,outliers", [
    ("recover", 128, False, 0.0), ("fix_scale", 128, True, 0.0),
    ("outliers", 256, False, 0.25)])
def test_sim3_ransac_matches_reference(case, n_samples, fix_scale, outliers):
    """TestSim3's three scenes with the same samples: the inlier sets >= 99%
    equal and S12 within 1e-4. Horn's eigenvector comes from another solver
    (torch.linalg.eigh here, jnp.linalg.eigh there), so hypotheses are held
    only through the result."""
    rng = np.random.default_rng(0)
    p1, p2, s, n_out = _ransac_scene(rng, fix_scale=fix_scale,
                                     outlier_frac=outliers)
    n = len(p1)
    samples = rng.integers(0, n, size=(n_samples, 3)).astype(np.int32)
    ones, valid = np.ones(n, np.float32), np.ones(n, bool)
    rj = jsim3_solver.sim3_ransac(
        JCamera.create(fx=500, fy=500, cx=320, cy=240), jnp.asarray(p1),
        jnp.asarray(p2), jnp.asarray(ones), jnp.asarray(ones),
        jnp.asarray(valid), jnp.asarray(samples), fix_scale=fix_scale)
    packed = sim3_ransac.sim3_ransac(
        Camera.create(500, 500, 320, 240), _t(p1), _t(p2), _t(ones), _t(ones),
        _t(valid), _t(samples), fix_scale=fix_scale)
    rt = sim3_ransac.unpack(packed.numpy(), n)
    assert rt.ok == bool(rj.ok)
    assert (rt.inliers == np.asarray(rj.inliers)).mean() >= 0.99
    np.testing.assert_allclose(rt.S12, np.asarray(rj.S12), atol=1e-4)
    # the reference test's own assertions on the port's result
    assert rt.ok
    if fix_scale:
        assert rt.S12[0] == 1.0
    else:
        np.testing.assert_allclose(rt.S12[0], s, rtol=0.05)
    if n_out:
        assert rt.inliers[:n_out].sum() <= 1


@pytest.mark.parametrize("case", ["refine", "outliers", "fix_scale"])
def test_optimize_sim3_matches_reference(case):
    """tests/test_sim3_opt.py's three cases: S12 within 1e-4; the inlier
    counts equal or off by one (a pair whose chi2 sits at the gate of 10
    may fall either side: the Jacobians come from torch.func there and
    jax.jacfwd here, summed in another order)."""
    rng = np.random.default_rng(0)
    if case == "refine":
        cam, p1c, p2c, u1, u2, S_true, _ = sim3_opt_problem(rng)
        xi = np.array([0.05, -0.08, 0.03, 0.02, -0.015, 0.025, 0.05], np.float32)
    elif case == "outliers":
        cam, p1c, p2c, u1, u2, S_true, _ = sim3_opt_problem(rng, outlier_frac=0.25)
        xi = np.zeros(7, np.float32)
    else:
        cam, p1c, p2c, u1, u2, S_true, _ = sim3_opt_problem(rng, s=1.0)
        xi = np.array([0, 0, 0, 0.01, -0.02, 0.01, 0], np.float32)
    fix_scale = case == "fix_scale"
    S0 = np.asarray(jgeo.sim3_compose(jgeo.sim3_exp(jnp.asarray(xi)),
                                      jnp.asarray(S_true)))
    n = len(p1c)
    ones, valid = np.ones(n, np.float32), np.ones(n, bool)
    rj = jsim3_opt.optimize_sim3(
        cam, jnp.asarray(S0), jnp.asarray(p1c), jnp.asarray(p2c),
        jnp.asarray(u1), jnp.asarray(u2), jnp.asarray(ones), jnp.asarray(ones),
        jnp.asarray(valid), fix_scale=fix_scale)
    packed = sim3_opt.optimize_sim3(
        Camera.create(500, 500, 320, 240, width=640, height=480), _t(S0),
        _t(p1c), _t(p2c), _t(u1), _t(u2), _t(ones), _t(ones), _t(valid),
        fix_scale=fix_scale)
    rt = sim3_opt.unpack(packed.numpy(), n)
    np.testing.assert_allclose(rt.S12, np.asarray(rj.S12), atol=1e-4)
    assert abs(rt.n_inliers - int(rj.n_inliers)) <= 1
    assert rt.n_inliers > 0.7 * n
    if fix_scale:
        np.testing.assert_allclose(rt.S12[0], 1.0, atol=1e-5)


def test_search_by_sim3_matches_reference():
    """TestSearchBySim3's scene (scale 1.05, shared descriptors, three
    corrupted): the matched indices and the agreement mask exact."""
    rng = np.random.default_rng(0)
    cam, p1c, p2c, _, _, S_true, _ = sim3_opt_problem(rng, s=1.05, noise_px=0.0)
    n = len(p1c)
    desc = rng.integers(0, 256, (n, 32)).astype(np.uint8)
    desc2 = desc.copy()
    desc2[:3] = rng.integers(0, 256, (3, 32)).astype(np.uint8)

    def proj(p):
        return (500 * p[:, :2] / p[:, 2:3] + [320, 240]).astype(np.float32)

    dmax1 = (np.linalg.norm(p1c, axis=1) * 1.1).astype(np.float32)
    dmax2 = (np.linalg.norm(p2c, axis=1) * 1.1).astype(np.float32)
    args = (S_true, p1c, desc, np.ones(n, bool), dmax1, proj(p1c),
            np.zeros(n, np.int32), p2c, desc2, np.ones(n, bool), dmax2,
            proj(p2c), np.zeros(n, np.int32))
    idx_j, mut_j = jsim3_opt.search_by_sim3(cam, *map(jnp.asarray, args),
                                            jnp.float32(1.2), 8)
    idx_t, mut_t = sim3_search.search_by_sim3(
        Camera.create(500, 500, 320, 240, width=640, height=480),
        *map(_t, args), 1.2, 8)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(mut_t.numpy(), np.asarray(mut_j))
    good = np.where(mut_t.numpy())[0]
    assert len(good) > 0.6 * n
    assert (idx_t.numpy()[good] == good).all()
