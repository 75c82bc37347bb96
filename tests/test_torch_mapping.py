"""Parity of the port's mapping path against the JAX package on the CPU:
point attributes, local bundle adjustment, and the batched triangulation
and fuse matching of local mapping on a rendered keyframe pair."""

import functools

import numpy as np
import torch

import jax.numpy as jnp

from orbslam2_tpu import local_mapping as jlm
from orbslam2_tpu.config import ExtractorConfig as JExtractorConfig
from orbslam2_tpu.models.camera import Camera as JCamera
from orbslam2_tpu.ops import ba as jba
from orbslam2_tpu.ops import orb as jorb
from orbslam2_tpu.ops import point_attrs as jpa
from orbslam2_tpu_torch import local_mapping as tlm
from orbslam2_tpu_torch.models.camera import Camera as TCamera
from orbslam2_tpu_torch.ops import ba as tba
from orbslam2_tpu_torch.ops import point_attrs as tpa
from orbslam2_tpu_torch.utils.synthetic import render_sequence

torch.set_num_threads(2)

W, H = 320, 240
K = np.array([[260.0, 0, 160], [0, 260, 120], [0, 0, 1]], np.float32)
CAM = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, bf=26.0, width=W, height=H)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def test_point_attributes():
    rng = np.random.default_rng(21)
    Kf, N, P, O = 12, 256, 400, 8
    kf_desc = rng.integers(0, 256, (Kf, N, 32)).astype(np.uint8)
    kf_oct = rng.integers(0, 4, (Kf, N)).astype(np.int32)
    poses = np.tile(np.eye(4, dtype=np.float32), (Kf, 1, 1))
    poses[:, :3, 3] = rng.normal(0, 0.5, (Kf, 3))
    n_obs = rng.integers(1, O + 1, P)
    obs_kf = np.full((P, O), -1, np.int16)
    obs_ft = np.full((P, O), -1, np.int16)
    for p in range(P):
        obs_kf[p, :n_obs[p]] = rng.choice(Kf, n_obs[p], replace=False)
        obs_ft[p, :n_obs[p]] = rng.integers(0, N, n_obs[p])
    pos = rng.uniform(-3, 3, (P, 3)).astype(np.float32) + np.float32([0, 0, 5])
    ref = np.where(rng.random(P) < 0.8, obs_kf[:, 0], -1).astype(np.int32)
    args = (kf_desc, kf_oct, poses, obs_kf, obs_ft, pos, ref)
    out_j = np.asarray(jpa.point_attributes(*(jnp.asarray(a) for a in args),
                                            jnp.float32(1.2), jnp.float32(3.0)))
    out_t = tpa.point_attributes(*(_t(a) for a in args), 1.2, 3.0).numpy()
    # the distinctive descriptor and reference keyframe are integer choices:
    # exact; the normal and the scale band are float32 sums: 1e-5
    np.testing.assert_array_equal(out_t[:, :32], out_j[:, :32])
    np.testing.assert_array_equal(out_t[:, 37], out_j[:, 37])
    np.testing.assert_allclose(out_t[:, 32:37], out_j[:, 32:37], rtol=1e-5, atol=1e-5)


def _ba_problem(Kc, M, O, seed):
    """The reference bench's BA window shape: K cameras along x, M points,
    O observations each with 0.5 px noise; camera 0 fixed."""
    rng = np.random.default_rng(seed)
    poses = np.tile(np.eye(4, dtype=np.float32), (Kc, 1, 1))
    poses[:, 0, 3] = np.linspace(0, 2, Kc)
    points = np.stack([rng.uniform(-3, 3, M), rng.uniform(-2, 2, M),
                       rng.uniform(5, 10, M)], 1).astype(np.float32)
    obs_kf = rng.integers(0, Kc, (M, O)).astype(np.int32)
    pc = np.einsum("moij,mj->moi", poses[obs_kf][..., :3, :3], points) + \
        poses[obs_kf][..., :3, 3]
    u = 260 * pc[..., 0] / pc[..., 2] + 160 + rng.normal(0, 0.5, (M, O))
    v = 260 * pc[..., 1] / pc[..., 2] + 120 + rng.normal(0, 0.5, (M, O))
    ur = np.where(rng.random((M, O)) < 0.3, u - 26.0 / pc[..., 2], -1.0)
    obs_uvr = np.stack([u, v, ur], -1).astype(np.float32)
    obs_valid = rng.random((M, O)) < 0.9
    obs_kf[~obs_valid & (rng.random((M, O)) < 0.5)] = -1
    # perturb the start so the solver has work to do
    poses_init = poses.copy()
    poses_init[1:, :3, 3] += rng.normal(0, 0.01, (Kc - 1, 3)).astype(np.float32)
    points_init = points + rng.normal(0, 0.02, points.shape).astype(np.float32)
    return [poses_init, np.arange(Kc) > 0, points_init, np.ones(M, bool), obs_kf,
            obs_uvr, np.ones((M, O), np.float32), obs_valid]


def test_optimize_ba_k16_m1024_o8():
    arrays = _ba_problem(16, 1024, 8, 22)
    rj = jba.optimize_ba(JCamera.create(**CAM),
                         jba.BAProblem(*(jnp.asarray(a) for a in arrays)),
                         iters=5, outlier_rounds=1)
    rt = tba.optimize_ba(TCamera.create(**CAM),
                         tba.BAProblem(*(_t(a) for a in arrays)),
                         iters=5, outlier_rounds=1)
    # float32 LM with sums in another order than XLA's: poses agree to 1e-4
    # (rotation entries, metres) and points, 5-10 m away, to 1e-4 relative;
    # the inlier classification may flip only at chi2 boundaries
    np.testing.assert_allclose(rt.poses.numpy(), np.asarray(rj.poses), atol=1e-4)
    np.testing.assert_allclose(rt.points.numpy(), np.asarray(rj.points),
                               rtol=1e-4, atol=1e-4)
    assert (rt.obs_inlier.numpy() != np.asarray(rj.obs_inlier)).mean() <= 0.001
    np.testing.assert_allclose(float(rt.cost), float(rj.cost), rtol=1e-3)
    # the solve moved the perturbed cameras
    assert np.abs(rt.poses.numpy() - arrays[0]).max() > 1e-3


@functools.lru_cache()
def _keyframe_pair():
    """Features, depth and true poses of rendered frames 0 and 8 (the
    reference extractor's output, handed to both packages)."""
    frames, poses = render_sequence(9, K, width=W, height=H, with_depth=True)
    ext = jorb.OrbExtractor(JExtractorConfig(n_features=500, n_levels=4), H, W)
    kfs = []
    for i in (0, 8):
        img, depth = frames[i]
        f = ext(img.astype(np.float32))
        xy = np.asarray(f.xy)
        v = np.asarray(f.valid)
        d = depth[np.clip(np.round(xy[:, 1]).astype(int), 0, H - 1),
                  np.clip(np.round(xy[:, 0]).astype(int), 0, W - 1)].astype(np.float32)
        d = np.where(v & (d > 0), d, -1.0).astype(np.float32)
        ur = np.where(d > 0, xy[:, 0] - 26.0 / np.maximum(d, 1e-6), -1.0).astype(np.float32)
        kfs.append(dict(desc=np.asarray(f.desc), xy=xy, oct=np.asarray(f.octave),
                        valid=v, depth=d, ur=ur, T=poses[i].astype(np.float32)))
    return kfs


def test_triangulation_rendered_pair():
    k1, k2 = _keyframe_pair()
    B = 2  # one real neighbour and one padding row (nb_ok False)
    stack = lambda key: np.stack([k2[key]] * B)  # noqa: E731
    # half of the features already have points: only the rest triangulate
    avail1 = k1["valid"] & (np.arange(len(k1["valid"])) % 2 == 0)
    nb_ok = np.array([True, False])
    args1 = (k1["desc"], k1["xy"], k1["oct"], avail1, k1["depth"], k1["ur"], k1["T"])
    args2 = (stack("desc"), stack("xy"), stack("oct"), stack("valid"),
             stack("depth"), stack("ur"), stack("T"), nb_ok)
    Xj, gj, ij = (np.asarray(a) for a in jlm._triangulate_neighbors_kernel(
        *(jnp.asarray(a) for a in args1 + args2), jnp.asarray(K),
        jnp.float32(0.1), jnp.float32(26.0), jnp.float32(1.2)))
    Xt, gt, it = (a.numpy() for a in tlm._triangulate_neighbors(
        *(_t(a) for a in args1 + args2), _t(K), 0.1, 26.0, 1.2))
    # matching is exact; the geometric gates are float32 tests that may
    # flip at their thresholds for a handful of points
    np.testing.assert_array_equal(it, ij)
    assert not gt[1].any() and not gj[1].any()
    assert gj[0].sum() > 20
    assert (gt != gj).sum() <= max(2, 0.01 * gj.sum())
    both = gt & gj
    np.testing.assert_allclose(Xt[both], Xj[both], rtol=1e-4, atol=1e-4)


def test_fuse_rendered_pair():
    k1, k2 = _keyframe_pair()
    # points: keyframe 0's features unprojected with their depth
    ok = k1["depth"] > 0
    d = k1["depth"][:, None]
    pc = np.concatenate([(k1["xy"][:, :1] - 160) / 260 * d,
                         (k1["xy"][:, 1:2] - 120) / 260 * d, d], 1)
    Twc = np.linalg.inv(k1["T"])
    pw = (pc @ Twc[:3, :3].T + Twc[:3, 3]).astype(np.float32)
    D = 2  # kf0 -> kf8 and kf0 -> kf0
    mp_pos = np.stack([pw, pw])
    mp_desc = np.stack([k1["desc"], k1["desc"]])
    mp_valid = np.stack([ok, ok])
    Tcw = np.stack([k2["T"], k1["T"]])
    kp = [np.stack([k2[k], k1[k]]) for k in ("xy", "desc", "oct", "valid")]
    rj = jlm._fuse_match_batch(
        *(jnp.asarray(a) for a in (mp_pos, mp_desc, mp_valid, Tcw, *kp)),
        JCamera.create(**CAM), jnp.float32(1.2), jnp.float32(3.0))
    rt = tlm._fuse_match(*(_t(a) for a in (mp_pos, mp_desc, mp_valid, Tcw, *kp)),
                         TCamera.create(**CAM), 1.2, 3.0)
    vj, vt = np.asarray(rj.valid), rt.valid.numpy()
    assert vj[0].sum() > 50 and vj[1].sum() > 200
    # the projection is a float32 product and may cross a radius or image
    # border for a point or two; every match both find is identical
    assert (vt != vj).sum() <= max(2, 0.005 * vj.sum())
    both = vt & vj
    np.testing.assert_array_equal(rt.idx.numpy()[both], np.asarray(rj.idx)[both])
    np.testing.assert_array_equal(rt.dist.numpy()[both], np.asarray(rj.dist)[both])


def _jax_map_with_points():
    """A reference MapState built through its host API: 3 keyframes from
    random features, 300 points each observed by 2-3 of them."""
    from orbslam2_tpu.config import SlamConfig as JSlamConfig
    from orbslam2_tpu.map.state import MapState as JMapState

    rng = np.random.default_rng(23)
    cfg = JSlamConfig(sensor="rgbd")
    m = JMapState.allocate(cfg)
    N = cfg.extractor.max_keypoints
    for k in range(3):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = -0.2 * k
        m.add_keyframe(T, rng.uniform(0, 600, (N, 2)).astype(np.float32),
                       rng.integers(0, 256, (N, 32)).astype(np.uint8),
                       rng.integers(0, 8, N).astype(np.int32),
                       rng.uniform(-3, 3, N).astype(np.float32),
                       np.ones(N, bool), k, k / 30.0)
    pts = rng.uniform(-2, 2, (300, 3)).astype(np.float32) + np.float32([0, 0, 4])
    mps = m.add_map_points_batch(pts, 0)
    for k in range(3):
        sel = mps[: 300 if k < 2 else 150]
        m.add_observations_batch(sel, k, rng.permutation(N)[: len(sel)])
    return cfg, m


def test_map_state_from_numpy_and_attribute_refresh():
    """convert.map_state_from_numpy hands the reference's map to the port;
    the host (< 128 points) and device (>= 128) attribute refreshes and the
    covisibility update then agree with the reference's."""
    import dataclasses

    from orbslam2_tpu_torch import config as tconfig
    from orbslam2_tpu_torch.utils.convert import map_state_from_numpy

    _, jm = _jax_map_with_points()
    fields = {f.name: getattr(jm, f.name) for f in dataclasses.fields(jm)
              if f.name not in ("cfg", "lock", "dev_kf")}
    tm = map_state_from_numpy(tconfig.SlamConfig(sensor="rgbd"), fields,
                              device="cpu")
    for name, value in fields.items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(getattr(tm, name), value)
    for m in (jm, tm):
        m.update_point_attributes(np.arange(50))          # host path
        m.dev_kf.ensure(m)
        m.update_point_attributes(np.arange(50, 300))     # device path
        m.update_connections(2)
    np.testing.assert_array_equal(tm.mp_desc, jm.mp_desc)
    np.testing.assert_array_equal(tm.mp_ref_kf, jm.mp_ref_kf)
    np.testing.assert_array_equal(tm.covis_idx, jm.covis_idx)
    np.testing.assert_array_equal(tm.covis_w, jm.covis_w)
    for name in ("mp_normal", "mp_dmin", "mp_dmax"):
        np.testing.assert_allclose(getattr(tm, name), getattr(jm, name),
                                   rtol=1e-5, atol=1e-5)
