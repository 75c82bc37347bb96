"""Parity of the port's relocalization solvers with the JAX package's:
Horn alignment (``ops/geometry.py``), EPnP RANSAC (``ops/pnp.py``, kernel
Z's plain version) and kernel U's matcher without the rotation check."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.models.camera import Camera as JCamera
from orbslam2_tpu.ops import geometry as jgeo
from orbslam2_tpu.ops import matching as jmatching
from orbslam2_tpu.ops import pnp as jpnp
from orbslam2_tpu_torch.kernels import match_rot, pnp_ransac
from orbslam2_tpu_torch.models.camera import Camera
from orbslam2_tpu_torch.ops import geometry as tgeo
from orbslam2_tpu_torch.ops import matching, pnp

torch.set_num_threads(2)

FX, CX, CY = 500.0, 320.0, 240.0
R_TRUE = np.asarray(jgeo.so3_exp(jnp.asarray([0.05, -0.1, 0.03]))).astype(np.float32)
T_TRUE = np.array([0.3, -0.2, 0.5], np.float32)


def _rotation_angle(Ra, Rb):
    """The angle between two rotations, from the chord |Ra - Rb|_F (well
    conditioned near 0, where arccos of the trace is not)."""
    d = np.linalg.norm(Ra.astype(np.float64) - Rb.astype(np.float64))
    return float(2.0 * np.arcsin(min(d / (2.0 * np.sqrt(2.0)), 1.0)))


@pytest.mark.parametrize("with_scale", [False, True])
def test_horn_align_matches_reference(with_scale):
    rng = np.random.default_rng(5)
    src = rng.normal(size=(2, 40, 3)).astype(np.float32)
    R = np.stack([np.asarray(jgeo.so3_exp(jnp.asarray(rng.normal(size=3) * 0.5)))
                  for _ in range(2)]).astype(np.float32)
    s_true = 1.7 if with_scale else 1.0
    dst = (s_true * src @ R.transpose(0, 2, 1) + rng.normal(size=(2, 1, 3))
           + rng.normal(0, 0.01, src.shape)).astype(np.float32)
    w = (rng.random((2, 40)) > 0.2).astype(np.float32)
    ref = jgeo.horn_align(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w),
                          with_scale=with_scale)
    out = tgeo.horn_align(torch.from_numpy(src), torch.from_numpy(dst),
                          torch.from_numpy(w), with_scale=with_scale)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)


def _problem(seed, n=200, noise=0.5, outlier_frac=0.3):
    """The reference solver tests' scene (tests/test_solvers.py) with 200
    points, octave variances 1.2^(2 o), 30% gross outliers first."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                    rng.uniform(4, 9, n)], 1).astype(np.float32)
    pw = ((pts - T_TRUE) @ R_TRUE).astype(np.float32)
    uv = FX * pts[:, :2] / pts[:, 2:3] + [CX, CY]
    uv = (uv + rng.normal(0, noise, (n, 2))).astype(np.float32)
    n_out = int(outlier_frac * n)
    uv[:n_out] += rng.uniform(40, 120, (n_out, 2)).astype(np.float32)
    sigma2 = (1.2 ** (2 * rng.integers(0, 4, n))).astype(np.float32)
    samples = rng.integers(0, n, (256, pnp.SAMPLE_SIZE)).astype(np.int32)
    return pw, uv, sigma2, samples, n_out


def _both(seed, noise=0.5):
    pw, uv, sigma2, samples, n_out = _problem(seed, noise=noise)
    n = len(pw)
    ref = jpnp.pnp_ransac(JCamera.create(FX, FX, CX, CY), jnp.asarray(pw),
                          jnp.asarray(uv), jnp.asarray(sigma2),
                          jnp.ones(n, bool), jnp.asarray(samples))
    out = pnp_ransac.unpack(pnp_ransac.pnp_ransac(
        Camera.create(FX, FX, CX, CY), torch.from_numpy(pw), torch.from_numpy(uv),
        torch.from_numpy(sigma2), torch.ones(n, dtype=torch.bool),
        torch.from_numpy(samples)).numpy(), n)
    return ref, out, n_out


def _lapack_pca(cov):
    """The reference's PCA: LAPACK's eigenvectors as numpy.linalg.eigh (and
    jnp.linalg.eigh on the CPU) give them, with their signs."""
    ev, V = np.linalg.eigh(cov.numpy())
    return torch.from_numpy(ev), torch.from_numpy(V)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pnp_ransac_matches_reference(seed, monkeypatch):
    """The same samples through both packages, with the PCA axes signed as
    the reference's eigen-solver signs them: ok equal, inlier sets equal
    in >= 99% of rows, rotation within 1e-3 rad, translation within 1e-3 m."""
    monkeypatch.setattr(pnp, "pca", _lapack_pca)
    ref, out, n_out = _both(seed)
    assert out.ok == bool(ref.ok)
    assert (out.inliers == np.asarray(ref.inliers)).mean() >= 0.99
    Tj = np.asarray(ref.Tcw)
    assert _rotation_angle(out.Tcw[:3, :3], Tj[:3, :3]) < 1e-3
    assert np.abs(out.Tcw[:3, 3] - Tj[:3, 3]).max() < 1e-3
    assert out.inliers[:n_out].sum() == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pnp_control_point_signs(seed):
    """ROADMAP queue 3, "PnP control points": with noise, EPnP's solution
    depends on the signs of the PCA axes that place the control points;
    the reference takes them as its eigen-solver returns them, the port
    fixes them (ops/pnp.pca). Then the two differ by the noise's effect
    only: ok and inliers as above, rotation within 1e-3 rad, translation
    within 1e-2 m, and both within 1e-2 m of the truth."""
    ref, out, _ = _both(seed)
    assert out.ok == bool(ref.ok)
    assert (out.inliers == np.asarray(ref.inliers)).mean() >= 0.99
    Tj = np.asarray(ref.Tcw)
    assert _rotation_angle(out.Tcw[:3, :3], Tj[:3, :3]) < 1e-3
    assert np.abs(out.Tcw[:3, 3] - Tj[:3, 3]).max() < 1e-2
    assert np.abs(out.Tcw[:3, 3] - T_TRUE).max() < 1e-2
    assert np.abs(Tj[:3, 3] - T_TRUE).max() < 1e-2


def _epnp_numpy(pw, uv):
    """EPnP of one point set in float64 numpy, written from the EPnP paper
    and the reference's steps (independently of ops/pnp.py); the PCA axes
    signed by their largest component, as the port signs them."""
    S = len(pw)
    c0 = pw.mean(0)
    ev, V = np.linalg.eigh((pw - c0).T @ (pw - c0) / S)
    V = V * np.sign(V[np.abs(V).argmax(0), np.arange(3)])
    Cw = np.vstack([c0, c0 + (V * np.sqrt(np.maximum(ev, 1e-9))).T])
    alphas = np.linalg.solve(np.vstack([Cw.T, np.ones(4)]),
                             np.vstack([pw.T, np.ones(S)])).T
    M = np.zeros((2 * S, 12))
    for i in range(S):
        for j in range(4):
            M[2 * i, 3 * j:3 * j + 3] = alphas[i, j] * np.array([FX, 0.0, CX - uv[i, 0]])
            M[2 * i + 1, 3 * j:3 * j + 3] = alphas[i, j] * np.array([0.0, FX, CY - uv[i, 1]])
    vb = np.linalg.eigh(M.T @ M)[1][:, :4].T.reshape(4, 4, 3)
    pairs = [(a, b) for a in range(4) for b in range(a + 1, 4)]
    dv = np.stack([vb[:, a] - vb[:, b] for a, b in pairs], 1)      # (4, 6, 3)
    rho = np.array([np.sum((Cw[a] - Cw[b]) ** 2) for a, b in pairs])
    cols = [(0, 0), (0, 1), (1, 1), (0, 2), (1, 2), (2, 2), (0, 3), (1, 3), (2, 3), (3, 3)]
    L = np.stack([(1.0 if i == j else 2.0) * np.sum(dv[i] * dv[j], -1)
                  for i, j in cols], 1)                               # (6, 10)

    def lsq(c):
        A = L[:, c]
        return np.linalg.solve(A.T @ A + 1e-9 * np.eye(len(c)), A.T @ rho)

    b = lsq([0, 1, 3, 6])
    b1, s1 = np.sqrt(abs(b[0])), (-1.0 if b[0] < 0 else 1.0)
    d = b1 if b1 > 1e-9 else 1.0
    seeds = [np.array([b1, s1 * b[1] / d, s1 * b[2] / d, s1 * b[3] / d])]
    b = lsq([0, 1, 2])
    seeds.append(np.array([np.sqrt(abs(b[0])),
                           np.copysign(np.sqrt(abs(b[2])), -1.0 if b[1] < 0 else 1.0),
                           0.0, 0.0]))
    b = lsq([0, 1, 2, 3, 4])
    b1 = np.sqrt(abs(b[0]))
    seeds.append(np.array([b1, (-1.0 if b[1] < 0 else 1.0) * np.sqrt(abs(b[2])),
                           b[3] / (b1 if b1 > 1e-9 else 1.0), 0.0]))
    best = None
    for beta in seeds:
        for _ in range(pnp.N_GN_ITERS):
            s = np.einsum("i,ipk->pk", beta, dv)
            e = np.sum(s * s, -1) - rho
            J = 2.0 * np.einsum("pk,ipk->pi", s, dv)
            beta = beta - np.linalg.solve(J.T @ J + 1e-6 * np.eye(4), J.T @ e)
        Cc = np.einsum("i,ipk->pk", beta, vb)
        if np.sum(alphas @ Cc[:, 2]) < 0:
            Cc = -Cc
        ms, md = Cw.mean(0), Cc.mean(0)
        U, _, Vt = np.linalg.svd((Cc - md).T @ (Cw - ms))
        R = U @ np.diag([1.0, 1.0, np.linalg.det(U @ Vt)]) @ Vt
        t = md - R @ ms
        pc = pw @ R.T + t
        sse = np.sum((FX * pc[:, :2] / pc[:, 2:3] + [CX, CY] - uv) ** 2)
        if best is None or sse < best[0]:
            best = (sse, R, t)
    return best[1], best[2]


@pytest.mark.parametrize("n", [6, 12])
def test_epnp_matches_float64_numpy(n):
    """The plain EPnP (float64, rounded to float32) of 32 sets of ``n``
    noisy points within 1e-6 of a float64 numpy EPnP. From six points on,
    M^T M has one smallest eigenvector and the solve is defined; on a
    4-point set its null space has four dimensions, and which hypotheses
    Gauss-Newton brings home depends on the eigen-solver's basis (see
    test_minimal_sets_converge)."""
    pw, uv, _, _, _ = _problem(7, outlier_frac=0.0)
    rng = np.random.default_rng(8)
    sets = np.stack([rng.choice(len(pw), n, replace=False) for _ in range(32)])
    hyp = pnp.hypotheses(Camera.create(FX, FX, CX, CY), torch.from_numpy(pw),
                         torch.from_numpy(uv), torch.from_numpy(sets)).numpy()
    for s, T in zip(sets, hyp):
        R, t = _epnp_numpy(pw[s].astype(np.float64), uv[s].astype(np.float64))
        np.testing.assert_allclose(T[:3, :3], R, rtol=0, atol=1e-6)
        np.testing.assert_allclose(T[:3, 3], t, rtol=0, atol=1e-6)


def test_minimal_sets_converge():
    """ROADMAP queue 3, "PnP minimal sets": on 256 noise-free 4-point
    samples of inliers, the hypotheses that reach the true pose (within
    1e-4 m) are a different subset in each package, set by the eigen-
    solver's basis of the 4-dimensional null space (numbers in PERF.md);
    each package brings home at least a tenth of them, which is what the
    RANSAC needs."""
    pw, uv, _, _, _ = _problem(12, noise=0.0, outlier_frac=0.0)
    samples = np.random.default_rng(11).integers(0, len(pw), (256, 4)).astype(np.int32)
    hyp = pnp.hypotheses(Camera.create(FX, FX, CX, CY), torch.from_numpy(pw),
                         torch.from_numpy(uv), torch.from_numpy(samples)).numpy()
    cam = JCamera.create(FX, FX, CX, CY)
    ref = np.asarray(jax.jit(jax.vmap(lambda s: jpnp._epnp_weighted(
        jnp.asarray(pw)[s], jnp.asarray(uv)[s], jnp.ones(4), cam)))(jnp.asarray(samples)))
    home_port = np.abs(hyp[:, :3, 3] - T_TRUE).max(1) < 1e-4
    home_ref = np.abs(ref[:, :3, 3] - T_TRUE).max(1) < 1e-4
    assert home_port.mean() >= 0.1 and home_ref.mean() >= 0.1
    assert (home_port != home_ref).any()


def test_match_without_rotation_check():
    """Kernel U's plain version with ``check_rotation=False`` is the
    relocalization matcher: ``match_descriptors(mutual=True,
    nn_ratio=0.75)`` of the port and of the JAX package, exactly."""
    rng = np.random.default_rng(9)
    b = rng.integers(0, 256, (300, 32)).astype(np.uint8)
    a = b[rng.permutation(300)[:250]].copy()
    flip = rng.integers(0, 256, a.shape).astype(np.uint8) & \
        (rng.random(a.shape) < 0.08).astype(np.uint8) * 0xFF
    a ^= flip
    a[:20] = a[20:40]                    # duplicated rows: ties and mutual fails
    va, vb = rng.random(250) > 0.05, rng.random(300) > 0.05
    t = [torch.from_numpy(x) for x in (a, b, va, vb)]
    out = match_rot.match_rot(*t, None, None, matching.TH_LOW, 0.75,
                              check_rotation=False)
    port = matching.match_descriptors(*t, max_dist=matching.TH_LOW, nn_ratio=0.75,
                                      mutual=True)
    ref = jmatching.match_descriptors(*(jnp.asarray(x) for x in (a, b, va, vb)),
                                      max_dist=jmatching.TH_LOW, nn_ratio=0.75,
                                      mutual=True)
    for o, p, r in zip(out, port, ref):
        np.testing.assert_array_equal(o.numpy(), p.numpy())
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    assert 50 < int(out.valid.sum()) < 230
