"""Parity of the port's tracking path against the JAX package on the CPU:
matching (kernel C's plain version), motion-only LM (kernel D's plain
version), the depth sampling and the whole fused cascade."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from orbslam2_tpu import tracking as jtrack
from orbslam2_tpu.config import ExtractorConfig as JExtractorConfig
from orbslam2_tpu.models.camera import Camera as JCamera
from orbslam2_tpu.ops import matching as jmatch
from orbslam2_tpu.ops import orb as jorb
from orbslam2_tpu.ops import pose_opt as jpose
from orbslam2_tpu_torch import tracking as ttrack
from orbslam2_tpu_torch.kernels import hamming as thamming
from orbslam2_tpu_torch.models.camera import Camera as TCamera
from orbslam2_tpu_torch.ops import matching as tmatch
from orbslam2_tpu_torch.ops import pose_opt as tpose
from orbslam2_tpu_torch.utils.synthetic import render_sequence

torch.set_num_threads(2)

W, H = 320, 240
K = np.array([[260.0, 0, 160], [0, 260, 120], [0, 0, 1]], np.float32)
CAM = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, bf=26.0, width=W, height=H)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _desc_pair(rng, na, nb, n_true):
    """B descriptors, and A = noisy copies of the first n_true of B (a few
    flipped bits) followed by random rows."""
    b = rng.integers(0, 256, (nb, 32)).astype(np.uint8)
    a = rng.integers(0, 256, (na, 32)).astype(np.uint8)
    flips = (rng.integers(0, 256, (n_true, 32)) & rng.integers(0, 256, (n_true, 32))
             & rng.integers(0, 256, (n_true, 32))).astype(np.uint8)
    a[:n_true] = b[:n_true] ^ flips
    return a, b


MATCH_CASES = {
    "projection": dict(max_dist=100, nn_ratio=0.9, use_pair=True, same_level=True),
    "reference_kf": dict(max_dist=50, nn_ratio=0.7, mutual=True, rotation=True),
    "plain": dict(max_dist=50, nn_ratio=1.0),
    "triangulation": dict(max_dist=50, nn_ratio=0.6, mutual=True, use_pair=True),
}


@pytest.mark.parametrize("case", sorted(MATCH_CASES))
def test_match_descriptors_exact(case):
    """Integer outputs (idx, dist, valid) are exact: Hamming distances are
    exact in both, and both take the first index on ties."""
    c = MATCH_CASES[case]
    rng = np.random.default_rng(11)
    na, nb = 300, 256
    a, b = _desc_pair(rng, na, nb, 200)
    va = rng.random(na) < 0.9
    vb = rng.random(nb) < 0.9
    pair = rng.random((na, nb)) < 0.5 if c.get("use_pair") else None
    ang_a = rng.uniform(-np.pi, np.pi, na).astype(np.float32)
    ang_b = (ang_a[:nb] + rng.normal(0, 0.05, nb)).astype(np.float32) if nb <= na else None
    oct_b = rng.integers(0, 4, nb).astype(np.int32)
    kw_j = dict(max_dist=c["max_dist"], nn_ratio=c["nn_ratio"],
                mutual=c.get("mutual", False))
    kw_t = dict(kw_j)
    if c.get("rotation"):
        kw_j.update(angles_a=jnp.asarray(ang_a), angles_b=jnp.asarray(ang_b),
                    check_rotation=True)
        kw_t.update(angles_a=_t(ang_a), angles_b=_t(ang_b), check_rotation=True)
    if c.get("same_level"):
        kw_j.update(octave_b=jnp.asarray(oct_b), ratio_same_level_only=True)
        kw_t.update(octave_b=_t(oct_b), ratio_same_level_only=True)
    rj = jmatch.match_descriptors(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(va), jnp.asarray(vb),
        pair_mask=None if pair is None else jnp.asarray(pair), **kw_j)
    rt = tmatch.match_descriptors(
        _t(a), _t(b), _t(va), _t(vb),
        pair_mask=None if pair is None else _t(pair), **kw_t)
    for f in ("idx", "dist", "valid"):
        np.testing.assert_array_equal(getattr(rt, f).numpy(),
                                      np.asarray(getattr(rj, f)))
    assert rt.valid.sum() > 20  # the case matched something


def test_hamming_top2_gated_plain_exact():
    """Kernel C's plain version against the reference's hamming_matrix +
    masked_top2 under the projection pair mask."""
    rng = np.random.default_rng(12)
    P, N = 700, 512
    a, b = _desc_pair(rng, P, N, 400)
    kp_xy = np.stack([rng.uniform(0, W, N), rng.uniform(0, H, N)], 1).astype(np.float32)
    proj = np.concatenate([kp_xy[:400] + rng.normal(0, 3, (400, 2)),
                           rng.uniform(0, W, (P - 400, 2))]).astype(np.float32)
    r_px = rng.uniform(4, 30, P).astype(np.float32)
    pred = rng.integers(0, 4, P).astype(np.int32)
    kp_oct = rng.integers(0, 4, N).astype(np.int32)
    kp_ur = np.where(rng.random(N) < 0.5, kp_xy[:, 0] - 5.0, -1.0).astype(np.float32)
    ur_pred = (proj[:, 0] - 5.0 + rng.normal(0, 4, P)).astype(np.float32)
    row_valid = rng.random(P) < 0.8
    kp_valid = rng.random(N) < 0.95

    jp = (jmatch.radius_gate(jnp.asarray(proj), jnp.asarray(kp_xy), jnp.asarray(r_px))
          & jmatch.octave_gate(jnp.asarray(pred), jnp.asarray(kp_oct), lo=-1, hi=0))
    ur_ok = (kp_ur[None] <= 0) | (np.abs(ur_pred[:, None] - kp_ur[None]) <= r_px[:, None])
    mask = jp & jnp.asarray(ur_ok) & jnp.asarray(row_valid[:, None] & kp_valid[None])
    ref = jmatch.masked_top2(jmatch.hamming_matrix(jnp.asarray(a), jnp.asarray(b)), mask)
    out = thamming.hamming_top2_gated_plain(
        _t(a), _t(proj), _t(r_px), _t(pred), _t(ur_pred), _t(row_valid),
        _t(b), _t(kp_xy), _t(kp_oct), _t(kp_valid), _t(kp_ur))
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    assert (out[1].numpy() <= 100).sum() > 100


def _pose_problem(seed, n, n_valid, stereo_frac=0.5):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                    rng.uniform(2, 8, n)], 1).astype(np.float32)
    T_true = np.eye(4, dtype=np.float32)
    T_true[:3, 3] = [0.05, -0.02, 0.1]
    pc = pts @ T_true[:3, :3].T + T_true[:3, 3]
    u = 260 * pc[:, 0] / pc[:, 2] + 160 + rng.normal(0, 0.7, n)
    v = 260 * pc[:, 1] / pc[:, 2] + 120 + rng.normal(0, 0.7, n)
    ur = np.where(rng.random(n) < stereo_frac, u - 26.0 / pc[:, 2], -1.0)
    obs = np.stack([u, v, ur], 1).astype(np.float32)
    bad = rng.random(n) < 0.1
    obs[bad, :2] += rng.uniform(-40, 40, (int(bad.sum()), 2))
    sigma2 = (1.2 ** (2.0 * rng.integers(0, 4, n))).astype(np.float32)
    valid = np.zeros(n, bool)
    valid[rng.choice(n, n_valid, replace=False)] = True
    return np.eye(4, dtype=np.float32), pts, obs, sigma2, valid, T_true


@pytest.mark.parametrize("n,n_valid", [(1024, 1024), (4096, 600)])
def test_optimize_pose(n, n_valid):
    T0, pts, obs, sigma2, valid, T_true = _pose_problem(13, n, n_valid)
    rj = jpose.optimize_pose(jnp.asarray(T0), JCamera.create(**CAM), jnp.asarray(pts),
                             jnp.asarray(obs), jnp.asarray(sigma2), jnp.asarray(valid))
    rt = tpose.optimize_pose(_t(T0), TCamera.create(**CAM), _t(pts), _t(obs),
                             _t(sigma2), _t(valid))
    # the plain version sums H, b and the costs in another order than XLA,
    # so the pose agrees to float32 rounding (1e-4 in rotation entries and
    # metres), and inliers may differ only at chi2 boundaries (<= 0.5%)
    np.testing.assert_allclose(rt.Tcw.numpy(), np.asarray(rj.Tcw), atol=1e-4)
    assert abs(int(rt.n_inliers) - int(rj.n_inliers)) <= 0.005 * n_valid
    assert (rt.inliers.numpy() != np.asarray(rj.inliers)).sum() <= 0.005 * n_valid
    assert np.abs(rt.Tcw.numpy()[:3, 3] - T_true[:3, 3]).max() < 5e-3


def test_rgbd_virtual_right():
    rng = np.random.default_rng(14)
    d = rng.uniform(0, 6, (H // 2, W // 2)).astype(np.float32)
    d[rng.random(d.shape) < 0.1] = 0
    d_u16 = (d * 1000).astype(np.uint16)
    xy = np.stack([rng.uniform(0, W, 512), rng.uniform(0, H, 512)], 1).astype(np.float32)
    valid = rng.random(512) < 0.9
    scale = np.float32(1.0 / np.float32(1e3))
    urj, dj = jtrack._rgbd_virtual_right_u16(
        jnp.asarray(d_u16), jnp.float32(scale), jnp.asarray(xy), jnp.asarray(xy),
        jnp.asarray(valid), jnp.float32(26.0), stride=2)
    urt, dt = ttrack.rgbd_virtual_right_u16(
        _t(d_u16.astype(np.int32)), float(scale), _t(xy), _t(xy), _t(valid), 26.0,
        stride=2)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    # u - bf / d: XLA evaluates the division as a reciprocal product, so
    # u_right agrees to a float32 rounding at pixel scale (the ulp of a
    # 320-px coordinate is 3.1e-5)
    np.testing.assert_allclose(urt.numpy(), np.asarray(urj), rtol=0, atol=3.1e-5)


@functools.lru_cache()
def _cascade_inputs():
    """A rendered frame's features (N=512) and a P=2048 local map: the
    frame's keypoints back-projected with their depth, then random points;
    the prediction is the true pose of the next frame, moved 2 cm."""
    (img0, depth0), (img1, _) = render_sequence(2, K, width=W, height=H,
                                                 with_depth=True)[0]
    ext = jorb.OrbExtractor(JExtractorConfig(n_features=500, n_levels=4), H, W)
    f0 = ext(img0.astype(np.float32))
    f1 = ext(img1.astype(np.float32))
    rng = np.random.default_rng(15)
    P = 2048
    xy0 = np.asarray(f0.xy)
    v0 = np.asarray(f0.valid)
    d = depth0[np.clip(np.round(xy0[:, 1]).astype(int), 0, H - 1),
               np.clip(np.round(xy0[:, 0]).astype(int), 0, W - 1)]
    n0 = len(xy0)
    pos = np.concatenate([rng.uniform(-2, 2, (P, 2)), rng.uniform(1, 5, (P, 1))], 1)
    pos[:n0] = np.stack([(xy0[:, 0] - 160) / 260 * d, (xy0[:, 1] - 120) / 260 * d, d], 1)
    desc = rng.integers(0, 256, (P, 32)).astype(np.uint8)
    desc[:n0] = np.asarray(f0.desc)
    valid = rng.random(P) < 0.5
    valid[:n0] = v0 & (d > 0)
    normal = pos / np.linalg.norm(pos, axis=1, keepdims=True)
    dist = np.linalg.norm(pos, axis=1)
    mp = dict(pos=pos.astype(np.float32), desc=desc, valid=valid,
              normal=normal.astype(np.float32),
              dmin=(dist / 1.2 ** 3).astype(np.float32), dmax=(dist * 1.2).astype(np.float32))
    kp = {k: np.asarray(getattr(f1, k)) for k in ("xy", "desc", "octave", "valid")}
    kp["ur"] = np.where(kp["valid"], kp["xy"][:, 0] - 26.0 / 3.0, -1.0).astype(np.float32)
    kp["depth"] = np.where(kp["valid"], 3.0, -1.0).astype(np.float32)
    T_pred = np.eye(4, dtype=np.float32)
    T_pred[0, 3] = 0.02
    return mp, kp, T_pred


def test_track_frame_fused_packed():
    mp, kp, T_pred = _cascade_inputs()
    args = [mp[k] for k in ("pos", "desc", "valid", "normal", "dmin", "dmax")] + \
        [kp[k] for k in ("xy", "desc", "octave", "valid", "ur", "depth")]
    pj = np.asarray(jtrack.track_frame_fused(
        JCamera.create(**CAM), jnp.asarray(T_pred), *(jnp.asarray(a) for a in args),
        jnp.float32(35.0), jnp.float32(15.0), jnp.float32(1.2), 4, 10))
    pt = ttrack.track_frame_fused(
        TCamera.create(**CAM), _t(T_pred), *(_t(a) for a in args),
        35.0, 15.0, 1.2, 4, 10).numpy()
    assert pt.shape == pj.shape == (20 + 2048,)
    # pose: float32 rounding of the LM sums (1e-4 in rotation entries and
    # metres); counts and per-point codes: >= 99% equal (a match at a chi2
    # or gate boundary may flip)
    np.testing.assert_allclose(pt[:16], pj[:16], atol=1e-4)
    assert pj[17] > 100  # the cascade tracked
    for i in (16, 17, 18, 19):
        assert abs(pt[i] - pj[i]) <= max(0.01 * pj[i], 1), (i, pt[i], pj[i])
    assert (pt[20:] == pj[20:]).mean() >= 0.99
