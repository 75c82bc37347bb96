"""Parity of the port's tracking path against the JAX package on the CPU:
matching (kernel C's plain version), motion-only LM (kernel D's plain
version), the depth sampling and undistortion (kernel L's plain version) and
the whole fused cascade."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from orbslam2_tpu import tracking as jtrack
from orbslam2_tpu.config import ExtractorConfig as JExtractorConfig
from orbslam2_tpu.models import camera as jcam
from orbslam2_tpu.models.camera import Camera as JCamera
from orbslam2_tpu.ops import matching as jmatch
from orbslam2_tpu.ops import orb as jorb
from orbslam2_tpu.ops import pose_opt as jpose
from orbslam2_tpu_torch import tracking as ttrack
from orbslam2_tpu_torch.kernels import hamming as thamming
from orbslam2_tpu_torch.kernels import match_rot as tmatch_rot
from orbslam2_tpu_torch.kernels import rgbd_depth as trgbd
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


def _depth_case(seed=14, n=512):
    """A stride-2 uint16 millimetre depth map of a 320x240 frame (10% holes)
    and n keypoints, 90% valid."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(0, 6, (H // 2, W // 2)).astype(np.float32)
    d[rng.random(d.shape) < 0.1] = 0
    xy = np.stack([rng.uniform(0, W, n), rng.uniform(0, H, n)], 1).astype(np.float32)
    return (d * 1000).astype(np.uint16), xy, rng.random(n) < 0.9


def test_rgbd_virtual_right():
    """Kernel L's plain version reads the uint16 map as the reference
    uploads it and divides as XLA does (IEEE): depth and u_right are
    bit-exact; without distortion the keypoints pass through."""
    d_u16, xy, valid = _depth_case()
    scale = np.float32(1.0 / np.float32(1e3))
    urj, dj = jtrack._rgbd_virtual_right_u16(
        jnp.asarray(d_u16), jnp.float32(scale), jnp.asarray(xy), jnp.asarray(xy),
        jnp.asarray(valid), jnp.float32(26.0), stride=2)
    xyt, urt, dt = trgbd.rgbd_depth(
        _t(d_u16), float(scale), _t(xy), _t(valid), TCamera.create(**CAM), stride=2)
    assert (np.asarray(dj) > 0).mean() > 0.7
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(urt.numpy(), np.asarray(urj))
    np.testing.assert_array_equal(xyt.numpy(), xy)


def test_rgbd_virtual_right_undistorts():
    """With a distorting camera kernel L's plain version also undistorts the
    keypoints: depths exact (sampled at the raw position), the undistorted
    keypoints and u_right within two float32 ulps of a 320-px coordinate
    (6.1e-5: XLA may round a step of the fixed-point iterations
    differently)."""
    cam = dict(CAM, fy=255.0, cx=161.0, cy=119.5, k1=-0.12, k2=0.03, p1=0.001,
               p2=-0.0008, k3=0.01)
    jc, tc = JCamera.create(**cam), TCamera.create(**cam)
    assert tc.has_distortion
    d_u16, xy, valid = _depth_case(15)
    scale = np.float32(1.0 / np.float32(1e3))
    xy_uj = jcam.undistort_points(jc, jnp.asarray(xy))
    urj, dj = jtrack._rgbd_virtual_right_u16(
        jnp.asarray(d_u16), jnp.float32(scale), jnp.asarray(xy), xy_uj,
        jnp.asarray(valid), jnp.float32(26.0), stride=2)
    xyt, urt, dt = trgbd.rgbd_depth(
        _t(d_u16), float(scale), _t(xy), _t(valid), tc, stride=2)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_allclose(xyt.numpy(), np.asarray(xy_uj), rtol=0, atol=6.1e-5)
    np.testing.assert_allclose(urt.numpy(), np.asarray(urj), rtol=0, atol=6.1e-5)
    assert np.abs(xyt.numpy() - xy).max() > 1.0  # the camera does distort


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


MP_KEYS = ("pos", "desc", "valid", "normal", "dmin", "dmax")
KP_KEYS = ("xy", "desc", "octave", "valid", "ur")


def _packed_pair(mp, kp, T_pred):
    """The packed cascade result of the reference and of the port."""
    args = [mp[k] for k in MP_KEYS] + [kp[k] for k in KP_KEYS + ("depth",)]
    pj = np.asarray(jtrack.track_frame_fused(
        JCamera.create(**CAM), jnp.asarray(T_pred), *(jnp.asarray(a) for a in args),
        jnp.float32(35.0), jnp.float32(15.0), jnp.float32(1.2), 4, 10))
    pt = ttrack.track_frame_fused(
        TCamera.create(**CAM), _t(T_pred), *(_t(a) for a in args),
        35.0, 15.0, 1.2, 4, 10).numpy()
    return pj, pt


def test_track_frame_fused_packed():
    mp, kp, T_pred = _cascade_inputs()
    pj, pt = _packed_pair(mp, kp, T_pred)
    assert pt.shape == pj.shape == (20 + 2048,)
    # pose: float32 rounding of the LM sums (1e-4 in rotation entries and
    # metres); counts and per-point codes: >= 99% equal (a match at a chi2
    # or gate boundary may flip)
    np.testing.assert_allclose(pt[:16], pj[:16], atol=1e-4)
    assert pj[17] > 100  # the cascade tracked
    for i in (16, 17, 18, 19):
        assert abs(pt[i] - pj[i]) <= max(0.01 * pj[i], 1), (i, pt[i], pj[i])
    assert (pt[20:] == pj[20:]).mean() >= 0.99


def _yawed(T, yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    out = T.copy()
    out[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    return out


def test_track_frame_fused_forced_retry():
    """A prediction 0.05 rad off in yaw: the first pass admits fewer than 10
    inliers, so the cascade takes the retry at twice the radius (the
    reference's lax.cond branch, decided on the device in the port), and
    the packed result matches the reference's as in the test above."""
    mp, kp, T_pred = _cascade_inputs()
    T_pred = _yawed(T_pred, 0.05)
    cam = TCamera.create(**CAM)
    mpa = [_t(mp[k]) for k in MP_KEYS]
    _, cl = ttrack.project_match(ttrack._KERNELS, cam, _t(T_pred), *mpa,
                                 *(_t(kp[k]) for k in KP_KEYS), 15.0, 1.2, 4)
    n1 = int(tpose.optimize_pose(_t(T_pred), cam, mpa[0], cl.obs, cl.sigma2,
                                 cl.keep).n_inliers)
    assert n1 < 10  # the first pass fails
    pj, pt = _packed_pair(mp, kp, T_pred)
    assert pj[16] > 50 and pj[17] > 100  # the retry recovered the motion
    np.testing.assert_allclose(pt[:16], pj[:16], atol=1e-4)
    for i in (16, 17, 18, 19):
        assert abs(pt[i] - pj[i]) <= max(0.01 * pj[i], 1), (i, pt[i], pj[i])
    assert (pt[20:] == pj[20:]).mean() >= 0.99


def test_claims_ties_take_the_lowest_point_index():
    """Map points 1200-1599 repeat points 0-399 (position, descriptor,
    normal, band), so every keypoint one of them claims is claimed at the
    same distance by two points: the lower index keeps it. The port's
    projection, kernel C's and kernel Q's plain versions against the
    reference's SearchByProjection (``track_against_points`` without pose
    optimisation)."""
    mp, kp, T_pred = _cascade_inputs()
    mp = {k: v.copy() for k, v in mp.items()}
    for v in mp.values():
        v[1200:1600] = v[:400]
    jc = JCamera.create(**CAM)
    _, idx_j, keep_j, _ = jtrack.track_against_points(
        jc, jnp.asarray(T_pred), *(jnp.asarray(mp[k]) for k in MP_KEYS),
        *(jnp.asarray(kp[k]) for k in KP_KEYS), jnp.float32(15.0),
        jnp.float32(1.2), 4, do_pose_opt=False)
    _, cl = ttrack.project_match(
        ttrack._KERNELS, TCamera.create(**CAM), _t(T_pred),
        *(_t(mp[k]) for k in MP_KEYS), *(_t(kp[k]) for k in KP_KEYS),
        15.0, 1.2, 4)
    keep = cl.keep.numpy()
    np.testing.assert_array_equal(keep, np.asarray(keep_j))
    np.testing.assert_array_equal(cl.kp_of_mp.numpy(), np.asarray(idx_j))
    # the originals keep their keypoints, no copy keeps one, and the
    # originals matched many (so the tie was decided many times)
    assert keep[:400].sum() > 30 and not keep[1200:1600].any()


def _match_rot_case(case, rng):
    """Kernel U's inputs: A rows 0..159 are noisy copies of B rows 0..159
    with angle differences spread over bins; "duplicates" repeats B rows
    (A rows 0-79 then tie between two columns) and A rows (columns 80-119
    tie between two rows); "equal_bins" puts 40 matches in each of bins 3, 7,
    11 and 15, so the histogram's top 3 are decided by the lower-bin rule."""
    na = nb = 320
    a, b = _desc_pair(rng, na, nb, 160)
    va = np.ones(na, bool) if case == "equal_bins" else rng.random(na) < 0.9
    vb = np.ones(nb, bool) if case == "equal_bins" else rng.random(nb) < 0.9
    if case == "duplicates":
        b[160:240] = b[0:80]
        a[240:280] = a[80:120]
    ang_b = rng.uniform(-np.pi, np.pi, nb).astype(np.float32)
    ang_a = rng.uniform(-np.pi, np.pi, na).astype(np.float32)
    two_pi = 2 * np.pi
    if case == "equal_bins":
        bins = np.array([3, 7, 11, 15])[np.arange(160) % 4]
    else:   # most in bin 0 (both signs of a small rotation), some in bin 20
        bins = np.where(np.arange(160) % 5 == 0, 20, 0)
    diff = (bins + 0.5) * two_pi / 30 + np.where(bins == 0, rng.uniform(-0.6, 0.6, 160) * two_pi / 30, 0)
    ang_a[:160] = np.mod(ang_b[:160] + diff + np.pi, two_pi) - np.pi
    xy_b = np.stack([rng.uniform(0, 640, nb), rng.uniform(0, 480, nb)], 1).astype(np.float32)
    xy_a = np.stack([rng.uniform(0, 640, na), rng.uniform(0, 480, na)], 1).astype(np.float32)
    xy_a[:160] = xy_b[:160] + rng.normal(0, 40, (160, 2)).astype(np.float32)
    return a, b, va, vb, ang_a.astype(np.float32), ang_b, xy_a, xy_b


@pytest.mark.parametrize("case", ["fallback", "windowed", "duplicates", "equal_bins"])
def test_match_rot_exact(case):
    """Kernel U's plain version against the reference's mutual, rotation-
    checked match_descriptors (the fallback: TH_LOW, ratio 0.7) and
    match_frames_windowed (SearchForInitialization: ratio 0.9, 100 px):
    idx, dist and valid exact, ties and equal histogram bins included."""
    rng = np.random.default_rng(21)
    a, b, va, vb, ang_a, ang_b, xy_a, xy_b = _match_rot_case(case, rng)
    if case == "windowed":
        rj = jtrack.match_frames_windowed(
            jnp.asarray(a), jnp.asarray(xy_a), jnp.asarray(ang_a), jnp.asarray(va),
            jnp.asarray(b), jnp.asarray(xy_b), jnp.asarray(ang_b), jnp.asarray(vb),
            jnp.float32(100.0), nn_ratio=0.9)
        rt = ttrack.match_frames_windowed(_t(a), _t(xy_a), _t(ang_a), _t(va), _t(b),
                                          _t(xy_b), _t(ang_b), _t(vb), 100.0, 0.9)
    else:
        rj = jmatch.match_descriptors(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(va), jnp.asarray(vb),
            max_dist=jmatch.TH_LOW, nn_ratio=0.7, mutual=True,
            angles_a=jnp.asarray(ang_a), angles_b=jnp.asarray(ang_b),
            check_rotation=True)
        rt = tmatch_rot.match_rot(_t(a), _t(b), _t(va), _t(vb), _t(ang_a), _t(ang_b),
                                  tmatch.TH_LOW, 0.7)
    for f in ("idx", "dist", "valid"):
        np.testing.assert_array_equal(getattr(rt, f).numpy(), np.asarray(getattr(rj, f)))
    valid = rt.valid.numpy()
    assert valid.sum() > 60
    if case == "equal_bins":   # bin 15 ties bins 3, 7, 11 and loses
        assert not valid[3:160:4].any() and valid[0:160:4].sum() > 30
    if case == "duplicates":
        # rows 0-79 tie between two columns: best == second fails the ratio;
        # columns 80-119 tie between two rows: the first row is the mutual one
        assert not valid[:80][vb[:80] & vb[160:240]].any()
        assert valid[80:120].sum() > 20
        assert not valid[240:280][va[80:120]].any()


def _off_so3(T, rng, eps=1e-4):
    """T with its rotation perturbed off SO(3) by ~eps, as a pose chained
    over many float32 compositions drifts."""
    out = T.copy()
    out[:3, :3] += rng.normal(0.0, eps, (3, 3)).astype(np.float32)
    return out


def _chain_links(seed=21):
    """(Tcw_prev, Tcw_prev2) around _cascade_inputs()'s prediction: the
    previous pose 1 cm behind it, the one before 2 cm, each slightly turned
    and off SO(3)."""
    rng = np.random.default_rng(seed)
    _, _, T_pred = _cascade_inputs()
    prev, prev2 = T_pred.copy(), T_pred.copy()
    prev[0, 3] -= 0.01
    prev2[0, 3] -= 0.02
    prev = _off_so3(_yawed(prev, 0.002), rng)
    prev2 = _off_so3(_yawed(prev2, 0.004), rng)
    return prev, prev2


@pytest.mark.parametrize("motion", [True, False])
def test_pose_chain_plain_matches_reference(motion):
    """Kernel R''s plain version against the reference's algebra
    (geometry.se3_orthonormalize on both links, vel = T_prev
    se3_inverse(T_prev2), vel T_prev; T_prev alone without the motion
    model) within 1e-6."""
    from orbslam2_tpu.ops import geometry as jgeo
    from orbslam2_tpu_torch.kernels import pose_chain

    prev, prev2 = _chain_links()
    a, b = jgeo.se3_orthonormalize(jnp.asarray(prev)), jgeo.se3_orthonormalize(jnp.asarray(prev2))
    ref = np.asarray(a @ jgeo.se3_inverse(b) @ a if motion else a)
    out = pose_chain.pose_chain(_t(prev), _t(prev2), motion).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)
    np.testing.assert_allclose(out[:3, :3] @ out[:3, :3].T, np.eye(3), atol=1e-6)
    link = pose_chain.pose_chain(_t(prev)).numpy()
    np.testing.assert_allclose(link, np.asarray(a), atol=1e-6)


@pytest.mark.parametrize("motion", [True, False])
def test_track_frame_fused_chained_matches_reference(motion):
    """The chained cascade (R', O, C, Q, D, R, R') against the reference's
    track_frame_fused_chained from the same links, off SO(3) by ~1e-4, with
    and without the motion model: the packed result at _packed_pair's
    tolerances (pose 1e-4, counts within 1%, codes >= 99% equal) and the
    next link within 1e-4."""
    mp, kp, _ = _cascade_inputs()
    prev, prev2 = _chain_links()
    args = [mp[k] for k in MP_KEYS] + [kp[k] for k in KP_KEYS + ("depth",)]
    pj, Tj = jtrack.track_frame_fused_chained(
        JCamera.create(**CAM), jnp.asarray(prev), jnp.asarray(prev2),
        jnp.asarray(motion), *(jnp.asarray(a) for a in args), jnp.float32(35.0),
        jnp.float32(15.0), jnp.float32(1.2), 4, 10)
    pj, Tj = np.asarray(pj), np.asarray(Tj)
    pt, Tt = ttrack.track_frame_fused_chained(
        TCamera.create(**CAM), _t(prev), _t(prev2), motion, *(_t(a) for a in args),
        35.0, 15.0, 1.2, 4, 10)
    pt, Tt = pt.numpy(), Tt.numpy()
    assert pj[17] > 100  # the cascade tracked
    np.testing.assert_allclose(pt[:16], pj[:16], atol=1e-4)
    for i in (16, 17, 18, 19):
        assert abs(pt[i] - pj[i]) <= max(0.01 * pj[i], 1), (i, pt[i], pj[i])
    assert (pt[20:] == pj[20:]).mean() >= 0.99
    np.testing.assert_allclose(Tt, Tj, atol=1e-4)
    # the next link is the packed pose re-projected onto SE(3)
    np.testing.assert_allclose(Tt[:3, :3] @ Tt[:3, :3].T, np.eye(3), atol=1e-6)
    np.testing.assert_allclose(Tt, pt[:16].reshape(4, 4), atol=1e-5)
