"""Parity of the port's two-view initializer (``ops/initializer.py``, kernel
X's plain version) against the JAX package on the CPU, function by function
and whole, on the scenes of ``tests/test_initializer.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from orbslam2_tpu.ops import initializer as jinit
from orbslam2_tpu_torch.kernels import two_view
from orbslam2_tpu_torch.ops import initializer as tinit

torch.set_num_threads(2)

K = np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]], np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _rot_y(deg):
    a = np.radians(deg)
    return np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                     [-np.sin(a), 0, np.cos(a)]], np.float32)


def _project(X, R=np.eye(3), t=np.zeros(3)):
    pc = X @ R.T + t
    uv = (pc[:, :2] / pc[:, 2:3]) * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
    return uv.astype(np.float32), pc[:, 2]


def _scene(name, seed=0, n=200):
    """(x1, x2, valid, samples) of the reference test's scenes: general (F),
    planar (H), general with 20% outliers, and pure rotation (fails)."""
    rng = np.random.default_rng(seed)
    R, t, noise, outliers, planar = {
        "general": (_rot_y(3.0), [-0.5, 0.05, 0.02], 0.3, 0.0, False),
        "planar": (_rot_y(4.0), [-0.6, 0.0, 0.05], 0.3, 0.0, True),
        "outliers": (_rot_y(3.0), [-0.5, 0.0, 0.0], 0.3, 0.2, False),
        "rotation": (_rot_y(5.0), [0.0, 0.0, 0.0], 0.2, 0.0, False),
    }[name]
    X = np.zeros((n, 3), np.float32)
    X[:, 0] = rng.uniform(-2, 2, n)
    X[:, 1] = rng.uniform(-1.5, 1.5, n)
    X[:, 2] = 5.0 + 0.2 * X[:, 0] if planar else rng.uniform(4.0, 8.0, n)
    x1, z1 = _project(X)
    x2, z2 = _project(X, R, np.asarray(t, np.float32))
    valid = (z1 > 0.1) & (z2 > 0.1)
    x1 = x1 + rng.normal(0, noise, x1.shape).astype(np.float32)
    x2 = x2 + rng.normal(0, noise, x2.shape).astype(np.float32)
    n_out = int(outliers * n)
    if n_out:
        x2[:n_out] += rng.uniform(20, 100, size=(n_out, 2)).astype(np.float32)
    samples = rng.choice(np.where(valid)[0], size=(jinit.N_ITERS, 8), replace=True)
    return x1, x2, valid, samples.astype(np.int32)


SCENES = ("general", "planar", "outliers", "rotation")


def _up_to_scale(a, b):
    """max |a/|a| - b/|b|| with the sign of b chosen to match a."""
    a = a.reshape(-1) / np.linalg.norm(a)
    b = b.reshape(-1) / np.linalg.norm(b)
    return min(np.abs(a - b).max(), np.abs(a + b).max())


def test_normalize_points():
    x1, _, valid, _ = _scene("general")
    xj, Tj = jinit.normalize_points(jnp.asarray(x1), jnp.asarray(valid))
    xt, Tt = tinit.normalize_points(_t(x1), _t(valid))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("solver", ["h", "f"])
def test_minimal_solvers(solver):
    """The minimal-set fits of the 200 hypotheses and the weighted refit.
    The port solves the normal equations in float64 (as kernel X does):
    its minimal fits equal the float64 null vector of the DLT system within
    1e-5 up to scale. H agrees with the reference within 1e-4 on every
    minimal set of 8 distinct points; the reference's float32 eigh of the
    squared 8-point system is itself off by up to ~0.4 for some F sets
    (PERF.md), so F is held to the float64 solve only. Both refits agree
    with the reference within 1e-4."""
    x1, x2, valid, samples = _scene("general")
    xn1, _ = jinit.normalize_points(jnp.asarray(x1), jnp.asarray(valid))
    xn2, _ = jinit.normalize_points(jnp.asarray(x2), jnp.asarray(valid))
    p1, p2 = np.asarray(xn1)[samples], np.asarray(xn2)[samples]
    distinct = np.array([len(set(r)) == 8 for r in samples])
    fj, ft = ((jinit._solve_h_dlt, tinit._solve_h_dlt) if solver == "h"
              else (jinit._solve_f_8point, tinit._solve_f_8point))
    Mt = ft(_t(p1), _t(p2)).numpy()
    u1, v1, u2, v2 = (a.astype(np.float64) for a in (p1[..., 0], p1[..., 1],
                                                      p2[..., 0], p2[..., 1]))
    z, o = np.zeros_like(u1), np.ones_like(u1)
    if solver == "h":
        A = np.concatenate([np.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], -1),
                            np.stack([u1, v1, o, z, z, z, -u2 * u1, -u2 * v1, -u2], -1)], 1)
    else:
        A = np.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, o], -1)
    null = np.linalg.svd(A)[2][:, -1]
    for k in np.where(distinct)[0]:
        M = Mt[k]
        if solver == "f":   # the rank-2 projection of the null vector
            U, S, Vt = np.linalg.svd(null[k].reshape(3, 3))
            assert _up_to_scale(M, U @ np.diag([S[0], S[1], 0.0]) @ Vt) < 1e-5
        else:
            assert _up_to_scale(M, null[k]) < 1e-5
    if solver == "h":
        Mj = np.asarray(fj(jnp.asarray(p1), jnp.asarray(p2)))
        assert max(_up_to_scale(a, b) for a, b in zip(Mt[distinct], Mj[distinct])) < 1e-4
    w = (np.arange(len(x1)) % 3 != 0).astype(np.float32)
    Rj = np.asarray(fj(xn1, xn2, jnp.asarray(w)))
    Rt = ft(_t(np.asarray(xn1)), _t(np.asarray(xn2)), _t(w)).numpy()
    assert _up_to_scale(Rt, Rj) < 1e-4


@pytest.mark.parametrize("model", ["h", "f"])
def test_scores(model):
    """Scores of every hypothesis within 1e-3 relative (the port inverts H
    in float64, the reference in float32: on an ill-conditioned H the
    scores differ by ~2e-4), inlier masks >= 99.9% equal, on the JAX
    package's own hypotheses."""
    x1, x2, valid, samples = _scene("outliers")
    xn1, T1 = jinit.normalize_points(jnp.asarray(x1), jnp.asarray(valid))
    xn2, T2 = jinit.normalize_points(jnp.asarray(x2), jnp.asarray(valid))
    if model == "h":
        M = jnp.linalg.inv(T2) @ jinit._solve_h_dlt(xn1[samples], xn2[samples]) @ T1
        sj, st = jinit.score_homography, tinit.score_homography
    else:
        M = T2.T @ jinit._solve_f_8point(xn1[samples], xn2[samples]) @ T1
        sj, st = jinit.score_fundamental, tinit.score_fundamental
    scj, inj = sj(M, jnp.asarray(x1)[None], jnp.asarray(x2)[None], jnp.asarray(valid)[None])
    sct, int_ = st(_t(np.asarray(M)), _t(x1)[None], _t(x2)[None], _t(valid)[None])
    np.testing.assert_allclose(sct.numpy(), np.asarray(scj), rtol=1e-3, atol=1e-3)
    assert (int_.numpy() == np.asarray(inj)).mean() >= 0.999


def test_decompositions():
    """The Faugeras H decomposition and the E decomposition give the same
    candidate poses (as sets: the SVD's signs may differ)."""
    R = _rot_y(4.0)
    t = np.array([-0.6, 0.0, 0.05], np.float32)
    t = t / np.linalg.norm(t)
    H = K @ (R + np.outer(t, [0.0, 0.0, 0.2])) @ np.linalg.inv(K)
    E = np.cross(np.eye(3), t) @ R   # [t]x R
    for fj, ft, args in ((jinit.decompose_homography, tinit.decompose_homography,
                          (H.astype(np.float32), K)),
                         (jinit.decompose_essential, tinit.decompose_essential,
                          (E.astype(np.float32),))):
        Rj, tj = fj(*(jnp.asarray(a) for a in args))
        Rt, tt = ft(*(_t(a) for a in args))
        Pj = np.concatenate([np.asarray(Rj).reshape(-1, 9), np.asarray(tj)], 1)
        Pt = np.concatenate([Rt.numpy().reshape(-1, 9), tt.numpy()], 1)
        for row in Pt:
            assert np.abs(Pj - row).max(1).min() < 1e-4
        for row in Pj:
            assert np.abs(Pt - row).max(1).min() < 1e-4


def test_check_rt():
    x1, x2, valid, samples = _scene("general")
    R, t = _rot_y(3.0), np.array([-0.5, 0.05, 0.02], np.float32)
    t = t / np.linalg.norm(t)
    nj, gj, Xj, pj = jinit.check_rt(jnp.asarray(R), jnp.asarray(t), jnp.asarray(x1),
                                    jnp.asarray(x2), jnp.asarray(valid), jnp.asarray(K))
    nt, gt, Xt, pt = tinit.check_rt(_t(R), _t(t), _t(x1), _t(x2), _t(valid), _t(K))
    assert abs(int(nt) - int(nj)) <= 1 and int(nj) > 150
    both = gt.numpy() & np.asarray(gj)
    rel = np.linalg.norm(Xt.numpy()[both] - np.asarray(Xj)[both], axis=1) / \
        np.linalg.norm(np.asarray(Xj)[both], axis=1)
    assert rel.max() < 1e-3
    assert abs(float(pt) - float(pj)) < 1e-3


def _hold_to(res_t, res_j):
    """The slice's tolerances: success and used_homography equal, T21 within
    1e-4, good agreeing in >= 99% of rows, points good in both within 1e-3
    relative."""
    assert bool(res_t.success) == bool(res_j.success)
    assert bool(res_t.used_homography) == bool(res_j.used_homography)
    if not bool(res_j.success):
        return
    np.testing.assert_allclose(np.asarray(res_t.T21), np.asarray(res_j.T21), atol=1e-4)
    gt, gj = np.asarray(res_t.good), np.asarray(res_j.good)
    assert (gt == gj).mean() >= 0.99
    both = gt & gj
    Pt, Pj = np.asarray(res_t.points3d)[both], np.asarray(res_j.points3d)[both]
    rel = np.linalg.norm(Pt - Pj, axis=1) / np.linalg.norm(Pj, axis=1)
    assert rel.max() < 1e-3, rel.max()


@pytest.mark.parametrize("scene", SCENES)
def test_initialize_two_view(scene):
    """The whole initializer on the same samples, and kernel X's wrapper
    (its plain version on CPU tensors, packed for one copy) likewise."""
    x1, x2, valid, samples = _scene(scene)
    res_j = jinit.initialize_two_view(jnp.asarray(x1), jnp.asarray(x2),
                                      jnp.asarray(valid), jnp.asarray(K),
                                      jnp.asarray(samples))
    assert bool(res_j.success) == (scene != "rotation")
    if scene != "rotation":
        assert bool(res_j.used_homography) == (scene == "planar")
    args = (_t(x1), _t(x2), _t(valid), _t(K), _t(samples))
    _hold_to(tinit.initialize_two_view(*args), res_j)
    packed = two_view.two_view(*args)
    _hold_to(two_view.unpack(packed.numpy(), len(x1)), res_j)
