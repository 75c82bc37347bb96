"""Parity of the PyTorch port's camera, geometry, small linear algebra and
image ops against the JAX package, on the same seeded numpy inputs (CPU)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from orbslam2_tpu.models import camera as jcam
from orbslam2_tpu.ops import geometry as jgeo
from orbslam2_tpu.ops import image as jimg
from orbslam2_tpu.ops import linalg_small as jls
from orbslam2_tpu_torch.kernels import pyramid as tpyr
from orbslam2_tpu_torch.models import camera as tcam
from orbslam2_tpu_torch.ops import geometry as tgeo
from orbslam2_tpu_torch.ops import image as timg
from orbslam2_tpu_torch.ops import linalg_small as tls

torch.set_num_threads(2)

# float32 elementwise math: the two frameworks may order or fuse a few
# operations differently, so outputs agree to a few float32 ulps of O(1)
# values, well inside 1e-5
TOL = 1e-5


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _close(a_jax, b_torch, tol=TOL):
    np.testing.assert_allclose(np.asarray(b_torch), np.asarray(a_jax),
                               rtol=tol, atol=tol)


CAM_ARGS = dict(fx=260.0, fy=255.0, cx=161.0, cy=119.5, k1=-0.12, k2=0.03,
                p1=0.001, p2=-0.0008, k3=0.0, bf=26.0, width=320, height=240)


def _cams():
    return jcam.Camera.create(**CAM_ARGS), tcam.Camera.create(**CAM_ARGS)


def test_camera_project_in_image():
    rng = np.random.default_rng(1)
    pc = np.stack([rng.uniform(-2, 2, 500), rng.uniform(-1.5, 1.5, 500),
                   rng.uniform(0.5, 8, 500)], 1).astype(np.float32)
    jc, tc = _cams()
    uv_j = jcam.project(jc, _j(pc))
    uv_t = tcam.project(tc, _t(pc))
    # pixel coordinates of a few hundred: relative tolerance
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), rtol=TOL)
    np.testing.assert_array_equal(tcam.in_image(tc, uv_t).numpy(),
                                  np.asarray(jcam.in_image(jc, uv_j)))


def test_camera_undistort_points():
    rng = np.random.default_rng(2)
    uv = np.stack([rng.uniform(0, 320, 400), rng.uniform(0, 240, 400)],
                  1).astype(np.float32)
    jc, tc = _cams()
    # eight fixed-point iterations on pixel coordinates: 1e-5 of the image
    # width (a coordinate near 0 carries the rounding of the 320-px scale)
    np.testing.assert_allclose(
        tcam.undistort_points(tc, _t(uv)).numpy(),
        np.asarray(jcam.undistort_points(jc, _j(uv))), rtol=TOL, atol=TOL * 320)
    assert tc.has_distortion and jc.has_distortion
    np.testing.assert_allclose(tc.K, np.asarray(jc.K))
    # the reference camera handed over through its fields
    from orbslam2_tpu_torch.utils.convert import camera_from_numpy

    assert camera_from_numpy({k: np.asarray(v) for k, v in jc._asdict().items()}) == tc


def _rand_phi(rng, n, scale):
    return (rng.normal(size=(n, 3)) * scale).astype(np.float32)


@pytest.mark.parametrize("scale", [1e-5, 0.3, 2.5])
def test_so3_exp_log(scale):
    rng = np.random.default_rng(3)
    phi = _rand_phi(rng, 200, scale)
    R_j = jgeo.so3_exp(_j(phi))
    R_t = tgeo.so3_exp(_t(phi))
    _close(R_j, R_t)
    _close(jgeo.so3_log(R_j), tgeo.so3_log(_t(np.asarray(R_j))))
    _close(jgeo.so3_left_jacobian(_j(phi)), tgeo.so3_left_jacobian(_t(phi)))
    _close(jgeo.hat(_j(phi)), tgeo.hat(_t(phi)))


def _rand_poses(rng, n):
    xi = np.concatenate([rng.normal(size=(n, 3)), rng.normal(size=(n, 3)) * 0.5],
                        1).astype(np.float32)
    return xi, np.asarray(jgeo.se3_exp(_j(xi)))


def test_se3_exp_log_inverse_orthonormalize():
    rng = np.random.default_rng(4)
    xi, T = _rand_poses(rng, 100)
    _close(jgeo.se3_exp(_j(xi)), tgeo.se3_exp(_t(xi)))
    _close(jgeo.se3_log(_j(T)), tgeo.se3_log(_t(T)), tol=1e-4)  # linear solve
    _close(jgeo.se3_inverse(_j(T)), tgeo.se3_inverse(_t(T)))
    noisy = T + rng.normal(size=T.shape).astype(np.float32) * 1e-3
    noisy[:, 3] = [0, 0, 0, 1]
    _close(jgeo.se3_orthonormalize(_j(noisy)), tgeo.se3_orthonormalize(_t(noisy)))
    pts = rng.normal(size=(100, 7, 3)).astype(np.float32)
    _close(jgeo.transform_points(_j(T), _j(pts)),
           tgeo.transform_points(_t(T), _t(pts)))
    _close(jgeo.apply_se3(_j(T), _j(pts[:, 0])), tgeo.apply_se3(_t(T), _t(pts[:, 0])))


def test_quaternions():
    rng = np.random.default_rng(5)
    _, T = _rand_poses(rng, 300)
    R = T[:, :3, :3]
    q_j = jgeo.rotmat_to_quat(_j(R))
    q_t = tgeo.rotmat_to_quat(_t(R))
    _close(q_j, q_t)
    _close(jgeo.quat_to_rotmat(q_j), tgeo.quat_to_rotmat(q_t))


def test_triangulate_dlt():
    rng = np.random.default_rng(6)
    K = np.array([[260, 0, 160], [0, 260, 120], [0, 0, 1]], np.float32)
    T1 = np.eye(4, dtype=np.float32)
    _, T2s = _rand_poses(rng, 1)
    T2 = np.eye(4, dtype=np.float32)
    T2[:3, :3] = np.asarray(jgeo.so3_exp(_j(np.float32([0.02, -0.05, 0.01]))))
    T2[:3, 3] = [-0.3, 0.05, 0.02]
    X = np.stack([rng.uniform(-2, 2, 300), rng.uniform(-1, 1, 300),
                  rng.uniform(2, 6, 300)], 1).astype(np.float32)

    def proj(T):
        pc = X @ T[:3, :3].T + T[:3, 3]
        return ((pc @ K.T)[:, :2] / pc[:, 2:]).astype(np.float32)

    P1 = (K @ T1[:3]).astype(np.float32)
    P2 = (K @ T2[:3]).astype(np.float32)
    x1 = proj(T1) + rng.normal(0, 0.3, (300, 2)).astype(np.float32)
    x2 = proj(T2) + rng.normal(0, 0.3, (300, 2)).astype(np.float32)
    Xj = np.asarray(jgeo.triangulate_dlt(_j(P1), _j(P2), _j(x1), _j(x2)))
    Xt = tgeo.triangulate_dlt(_t(P1), _t(P2), _t(x1), _t(x2)).numpy()
    # three inverse-iteration solves of a Gram matrix with entries up to
    # ~1e6: agreement to 1e-5 relative in metres
    np.testing.assert_allclose(Xt, Xj, rtol=1e-5, atol=1e-5)
    assert np.abs(Xt - X).mean() < 0.05  # and it is a triangulation


def test_linalg_small():
    rng = np.random.default_rng(7)
    A3 = rng.normal(size=(200, 3, 3)).astype(np.float32) + 3 * np.eye(3, dtype=np.float32)
    _close(jls.inv3x3(_j(A3)), tls.inv3x3(_t(A3)))
    B = rng.normal(size=(200, 6, 6)).astype(np.float32)
    S = B @ B.transpose(0, 2, 1) + 6 * np.eye(6, dtype=np.float32)
    b = rng.normal(size=(200, 6)).astype(np.float32)
    _close(jls.cholesky_small(_j(S), 6), tls.cholesky_small(_t(S), 6))
    _close(jls.solve_spd_small(_j(S), _j(b)), tls.solve_spd_small(_t(S), _t(b)))


# Pyramid / blur: grey levels in [0, 255]; the blur is bit-exact, the resize
# rounds its two products where XLA's dense matrix product fuses one into an
# FMA (see TWO_TAP_TOL below), so levels agree to 1e-3 grey levels, not bit
# for bit.
IMG_TOL = 1e-3


def _image(seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(240, 320)).astype(np.float32)


def test_gaussian_blur():
    img = _image(8)
    np.testing.assert_allclose(timg.gaussian_blur(_t(img)).numpy(),
                               np.asarray(jimg.gaussian_blur(_j(img))),
                               atol=IMG_TOL)


@pytest.mark.parametrize("out_hw", [(200, 267), (139, 185), (240, 320)])
def test_resize_bilinear(out_hw):
    img = _image(9)
    np.testing.assert_array_equal(tpyr.resize_matrix(240, out_hw[0]),
                                  jimg._resize_matrix(240, out_hw[0]))
    np.testing.assert_allclose(timg.resize_bilinear(_t(img), out_hw).numpy(),
                               np.asarray(jimg.resize_bilinear(_j(img), out_hw)),
                               atol=IMG_TOL)


def test_build_pyramid():
    img = _image(10)
    assert timg.pyramid_shapes(480, 640, 8, 1.2) == jimg.pyramid_shapes(480, 640, 8, 1.2)
    lv_j = jimg.build_pyramid(_j(img), 8, 1.2)
    lv_t = timg.build_pyramid(_t(img), 8, 1.2)
    assert [tuple(x.shape) for x in lv_t] == [tuple(x.shape) for x in lv_j]
    for a, b in zip(lv_j, lv_t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=IMG_TOL)


# The two-tap resize rounds each product and the sum once; XLA's dot over the
# dense matrix accumulates them its own way (an FMA in some blockings), so a
# pixel may differ from the reference by a few float32 ulps of a grey level
# (the ulp of 128-255 is 1.5e-5); most pixels are identical.
TWO_TAP_TOL = 1e-4


def test_two_tap_resize():
    """The resize as two taps per output row and column (kernel I's plain
    version) reproduces the reference's interpolation matrices, and its
    levels agree with the reference's matrix products to TWO_TAP_TOL."""
    for n_in, n_out in [(240, 200), (320, 267), (139, 116), (480, 400), (7, 5)]:
        idx, w = tpyr.resize_taps(n_in, n_out)
        M = np.zeros((n_out, n_in), np.float32)
        np.add.at(M, (np.arange(n_out)[:, None], idx), w)
        np.testing.assert_array_equal(M, jimg._resize_matrix(n_in, n_out))
    img = _image(12)
    lv_j = jimg.build_pyramid(_j(img), 8, 1.2)
    lv_t = timg.build_pyramid(_t(img), 8, 1.2)
    for a, b in zip(lv_j[1:], lv_t[1:]):
        a, b = np.asarray(a), b.numpy()
        np.testing.assert_allclose(b, a, rtol=0, atol=TWO_TAP_TOL)
        assert (a == b).mean() > 0.5
    np.testing.assert_allclose(timg.resize_bilinear(_t(img), (139, 185)).numpy(),
                               np.asarray(jimg.resize_bilinear(_j(img), (139, 185))),
                               rtol=0, atol=TWO_TAP_TOL)


def test_evaluation_metrics():
    """The port's own copy of the evaluation module gives the reference's
    ATE and RPE."""
    from orbslam2_tpu.utils import evaluation as jev
    from orbslam2_tpu_torch.utils import evaluation as tev

    rng = np.random.default_rng(11)
    _, T = _rand_poses(rng, 40)
    gt = T.astype(np.float64)
    est = gt.copy()
    est[:, :3, 3] += rng.normal(0, 0.01, (40, 3))
    for with_scale in (False, True):
        assert tev.ate_rmse(est[:, :3, 3], gt[:, :3, 3], with_scale) == \
            jev.ate_rmse(est[:, :3, 3], gt[:, :3, 3], with_scale)
    assert tev.rpe(est, gt, 2) == jev.rpe(est, gt, 2)
