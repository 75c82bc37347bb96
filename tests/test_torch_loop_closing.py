"""The port's loop closer on tests/test_loop_closing.py's drifted
20-keyframe circle (built by the reference's ``build_drifted_loop`` and
carried over with utils/convert.py), kernels as their plain versions:
the reference's two tests with their assertions, slice parity against the
JAX LoopCloser, and global BA, padded to the reference's bucket or sized to
the live map, past the old 64-camera limit, and on a landmark mesh."""

import dataclasses

import numpy as np
import pytest
import torch

from orbslam2_tpu_torch import config as tconfig
from orbslam2_tpu_torch.loop_closing import LoopCloser
from orbslam2_tpu_torch.map.keyframe_database import KeyFrameDatabase
from orbslam2_tpu_torch.models.camera import Camera
from orbslam2_tpu_torch.ops import ba
from orbslam2_tpu_torch.ops import geometry as geo
from orbslam2_tpu_torch.utils.convert import (map_state_from_numpy,
                                              set_loop_closer_state)
from test_loop_closing import build_drifted_loop

torch.set_num_threads(2)

INJECTED = np.float32([0.04, 0.015, -0.03])  # drift per keyframe


def _cfg():
    """build_drifted_loop's configuration, in the port's config module."""
    return tconfig.SlamConfig(
        sensor="rgbd",
        camera=tconfig.CameraConfig(fx=300, fy=300, cx=160, cy=120, width=320,
                                    height=240, bf=30.0, fps=30),
        extractor=tconfig.ExtractorConfig(n_features=256, n_levels=4),
        capacity=tconfig.MapCapacityConfig(max_keyframes=64, max_map_points=8192))


def _port_closer(jm):
    """The port's LoopCloser over a copy of the reference map ``jm``."""
    fields = {f.name: getattr(jm, f.name) for f in dataclasses.fields(jm)
              if f.name not in ("cfg", "lock", "dev_kf")}
    m = map_state_from_numpy(_cfg(), fields, device="cpu")
    cam = Camera.create(300, 300, 160, 120, bf=30.0, width=320, height=240)
    return LoopCloser(_cfg(), m, cam, KeyFrameDatabase(m, device="cpu"))


@pytest.fixture(scope="module")
def closed():
    """The port's closer after the drifted circle's keyframes, loop closed
    without global BA (as the reference test runs it)."""
    _, jm, _, gt = build_drifted_loop(np.random.default_rng(0))
    lc = _port_closer(jm)
    closures = [kf for kf in lc.map.valid_keyframes()
                if lc.process_keyframe(int(kf), run_global_ba=False)]
    return lc, closures, gt


def _reprojection_medians(m, kfs):
    errs = []
    for kf in kfs:
        T = m.kf_pose[kf]
        feats = np.where(m.kf_mp[kf] >= 0)[0]
        mps = m.kf_mp[kf, feats]
        live = m.mp_valid[mps]
        feats, mps = feats[live], mps[live]
        pc = m.mp_pos[mps] @ T[:3, :3].T + T[:3, 3]
        z = np.maximum(pc[:, 2], 1e-6)
        u = 300 * pc[:, 0] / z + 160
        v = 300 * pc[:, 1] / z + 120
        errs.append(np.median(np.hypot(u - m.kf_xy[kf, feats, 0],
                                       v - m.kf_xy[kf, feats, 1])))
    return errs


class TestLoopClosing:
    """tests/test_loop_closing.py on the port, the reference's assertions."""

    def test_detect_and_correct(self, closed):
        lc, closures, gt_poses = closed
        m = lc.map
        assert closures, "loop was not detected/corrected"
        last = len(m.valid_keyframes()) - 1
        T = torch.from_numpy(m.kf_pose[last]) @ geo.se3_inverse(
            torch.from_numpy(gt_poses[last]))
        err = np.linalg.norm(geo.se3_log(T).numpy())
        inj = np.linalg.norm(INJECTED * last)
        assert err < 0.5 * inj, (err, inj)
        errs = _reprojection_medians(m, (0, last // 2, last))
        assert max(errs) < 1.0, errs
        last_mps = m.kf_mp[last][m.kf_mp[last] >= 0]
        last_mps = last_mps[m.mp_valid[last_mps]]
        n_orig = (m.mp_first_kf[last_mps] <= 3).sum()
        assert n_orig >= 10, n_orig

    def test_no_loop_without_revisit(self):
        _, jm, _, _ = build_drifted_loop(np.random.default_rng(0), n_kf=8)
        lc = _port_closer(jm)
        assert not any(lc.process_keyframe(kf, run_global_ba=False)
                       for kf in range(4))


@pytest.fixture(scope="module")
def jax_closed():
    """The JAX LoopCloser over the same drifted circle, run as the port's is
    in ``closed``: (closer, map, closing keyframes, loop pair, the RANSAC's
    and the refinement's inlier counts, the first draw of the port's
    generator after the closers' state was carried across, the same draw
    from the reference's seed)."""
    from orbslam2_tpu.loop_closing import LoopCloser as JLoopCloser
    from orbslam2_tpu.map.keyframe_database import KeyFrameDatabase as JKeyFrameDatabase
    from orbslam2_tpu.ops import sim3_opt as jsim3_opt
    from orbslam2_tpu.ops import sim3_solver as jsim3_solver

    jcfg, jm, jcam, _ = build_drifted_loop(np.random.default_rng(0))
    jlc = JLoopCloser(jcfg, jm, jcam, JKeyFrameDatabase(jm))
    fresh = set_loop_closer_state(_port_closer(jm), dict(
        consistent_groups=jlc.consistent_groups, last_loop_kf=jlc.last_loop_kf,
        loops_closed=jlc.loops_closed, rng_state=jlc._rng.bit_generator.state))
    draws = (fresh._rng.integers(0, 1 << 30),
             np.random.default_rng(jcfg.runtime.seed + 1).integers(0, 1 << 30))
    seen = {}
    j_closures, j_pair = [], None
    with pytest.MonkeyPatch.context() as mp:
        for mod, name, key in ((jsim3_solver, "sim3_ransac", "ransac_inliers"),
                               (jsim3_opt, "optimize_sim3", "refined_inliers")):
            def wrapped(*a, _f=getattr(mod, name), _k=key, **k):
                res = _f(*a, **k)
                seen[_k] = int(res.n_inliers)
                return res
            mp.setattr(mod, name, wrapped)
        for kf in jm.valid_keyframes():
            if jlc.process_keyframe(int(kf), run_global_ba=False):
                j_closures.append(int(kf))
                j_pair = jm.loop_edges[-1]
    return jlc, jm, j_closures, j_pair, seen, draws


def test_loop_closing_slice_parity(closed, jax_closed):
    """The same drifted map through the JAX LoopCloser and the port's, the
    closers' state carried across (utils/convert.set_loop_closer_state):
    the same loop pair closes at the same keyframe, with the same RANSAC and
    refined inlier counts (+-1: a pair at the chi2 gate may fall either
    side in float32), and the corrected keyframe poses within 1e-3 (the
    pose graphs agree to that, test_torch_pose_graph.py)."""
    lc, closures, _ = closed
    _, jm, j_closures, j_pair, seen, draws = jax_closed
    assert draws[0] == draws[1]
    assert [int(k) for k in closures] == j_closures
    assert tuple(lc.map.loop_edges[-1]) == tuple(j_pair)
    assert abs(lc.last_stats["ransac_inliers"] - seen["ransac_inliers"]) <= 1
    assert abs(lc.last_stats["refined_inliers"] - seen["refined_inliers"]) <= 1
    kfs = jm.valid_keyframes()
    np.testing.assert_allclose(lc.map.kf_pose[kfs], jm.kf_pose[kfs], atol=1e-3)


def _gathers_equal(jsnap, psnap):
    """The JAX gather (padded to its bucket) and the port's (live size) hold
    the same keyframes, the same one fixed, the same points and
    observations; returns the live size (K, M)."""
    jprob, jkfs, jmp, jopt, jn = jsnap
    pprob, pkfs, pmp, popt, pn = psnap
    K = len(pkfs)
    assert list(jkfs) == list(pkfs) and jn == pn
    np.testing.assert_array_equal(jmp, pmp)
    np.testing.assert_array_equal(jopt[:K], popt)
    assert not popt[0] and popt[1:].all()
    for name, n in (("poses", K), ("opt_mask", K), ("points", pn),
                    ("point_valid", pn), ("obs_kf", pn), ("obs_uvr", pn),
                    ("obs_sigma2", pn), ("obs_valid", pn)):
        np.testing.assert_array_equal(np.asarray(getattr(jprob, name))[:n],
                                      getattr(pprob, name).numpy(), err_msg=name)
    return K, pn


def test_gba_matches_reference(jax_closed):
    """Global BA on the JAX closer's closed circle, carried into the port,
    against the JAX LoopCloser's, piece by piece.

    The gathers are equal (the reference's padded to its (32, 4096)
    bucket, compared on the live part): the same keyframes, the same one
    fixed, the same points and observations. The solves (3 iterations)
    agree within poses 2e-2, points 1e-2 relative, cost 1.5e-2 relative and
    no more inlier flips than tests/test_torch_ba.py's 0.1%. That is not
    test_torch_ba.py's 1e-4, because this problem (about two observations
    a point; the poses move by up to 0.54 in 3 iterations) spreads under
    any change of summation order: the port's own solve of it, padded to
    the bucket or at the live size, differs by 4.8e-3 in the poses and
    1.8e-3 in the points, the two packages by 7.7e-3 and 2.9e-3, with cost
    4.6e-3 relative and no flip (measured). test_torch_ba.py holds the
    solve to 1e-4 on well-posed windows.

    Then two consecutive keyframes of the circle's middle are left out of a
    second gather in both and restored before the write-back, as keyframes
    a solve did not see, so the write-back's spanning-tree propagation
    moves them (the second through the first) and the points only they
    observe. Each write-back, given the JAX solve of that gather, leaves
    the same map: poses and points within 1e-5."""
    jlc, jm = jax_closed[:2]
    plc = _port_closer(jm)
    pm = plc.map
    jsnap = jlc._gba_gather(None, None, 8)
    psnap = plc._gba_gather(None, None, 8)
    K, n = _gathers_equal(jsnap, psnap)
    jres = jlc._gba_solve(jsnap[0], 3, False)
    pres = plc._gba_solve(psnap[0], 3)
    np.testing.assert_allclose(pres.poses.numpy(), np.asarray(jres.poses)[:K],
                               atol=2e-2)
    np.testing.assert_allclose(pres.points.numpy(), np.asarray(jres.points)[:n],
                               rtol=1e-2, atol=1e-2)
    assert (pres.obs_inlier.numpy()
            != np.asarray(jres.obs_inlier)[:n]).mean() <= 1e-3
    np.testing.assert_allclose(float(pres.cost), float(jres.cost), rtol=1.5e-2)

    in_order = sorted((int(k) for k in jm.valid_keyframes()),
                      key=lambda k: int(jm.kf_seq[k]))
    left_out = in_order[len(in_order) // 2:][:2]
    for m in (jm, pm):
        m.kf_valid[left_out] = False
    jsnap = jlc._gba_gather(None, None, 8)
    psnap = plc._gba_gather(None, None, 8)
    for m in (jm, pm):
        m.kf_valid[left_out] = True
    K, n = _gathers_equal(jsnap, psnap)
    assert not set(left_out) & set(psnap[1])
    assert len(np.setdiff1d(pm.valid_map_points(), psnap[2])) > 0
    jres = jlc._gba_solve(jsnap[0], 3, False)
    poses, points = np.asarray(jres.poses), np.asarray(jres.points)
    before = pm.kf_pose[left_out].copy()
    jlc._gba_write_back(jsnap[1], jsnap[3], poses, jsnap[2], points[:n])
    plc._gba_write_back(psnap[1], psnap[3], poses[:K], psnap[2], points[:n])
    assert (np.abs(pm.kf_pose[left_out] - before).max((1, 2)) > 1e-4).all()
    kfs = jm.valid_keyframes()
    np.testing.assert_array_equal(pm.valid_keyframes(), kfs)
    np.testing.assert_allclose(pm.kf_pose[kfs], jm.kf_pose[kfs], atol=1e-5)
    mps = jm.valid_map_points()
    np.testing.assert_array_equal(pm.valid_map_points(), mps)
    np.testing.assert_allclose(pm.mp_pos[mps], jm.mp_pos[mps], atol=1e-5)


def test_gba_padded_matches_live_size(closed):
    """The reference pads global BA to its size buckets; the port solves
    the live map's size. Padded cameras are fixed and padded points
    invalid, so the plain schedule on a 24-camera, 1000-point window and on
    the same window padded to the reference's bucket (K=32, M=4096) agree
    within tests/test_torch_ba.py's BA tolerance: poses 1e-4, points 1e-4
    relative, inlier flips <= 0.1%, cost 1e-3 relative. (The drifted
    circle's own GBA problem, about two observations a point, moves its
    poses by 2e-4 after one iteration under any change of summation order,
    padded or not, so it is not the instrument for this.) Then the port's
    global BA on the circle: the live size gathered, solved and written
    back, and the map still reprojects at sub-pixel medians."""
    from orbslam2_tpu_torch.utils.synthetic import ba_window

    cam = Camera.create(520.0, 520.0, 320.0, 240.0, bf=52.0)
    prob = ba.BAProblem(*(torch.from_numpy(a) for a in ba_window(24, 1000, 8)))
    padded = ba.pad_problem(prob, 32, 4096)
    r = ba.optimize_ba_plain(cam, prob, iters=10)
    rp = ba.optimize_ba_plain(cam, padded, iters=10)
    np.testing.assert_allclose(r.poses.numpy(), rp.poses[:24].numpy(), atol=1e-4)
    np.testing.assert_allclose(r.points.numpy(), rp.points[:1000].numpy(),
                               rtol=1e-4, atol=1e-4)
    assert (r.obs_inlier != rp.obs_inlier[:1000]).float().mean().item() <= 1e-3
    np.testing.assert_allclose(float(r.cost), float(rp.cost), rtol=1e-3)

    lc, _, _ = closed
    gathered, kfs, _, _, n_ids = lc._gba_gather(None, None, 8)
    assert gathered.poses.shape[0] == len(kfs) == len(lc.map.valid_keyframes())
    assert gathered.points.shape[0] == n_ids
    lc.global_bundle_adjustment()
    assert max(_reprojection_medians(lc.map, kfs)) < 1.0


def test_gba_schedule_past_the_single_block_limit():
    """The plain global-BA schedule at K = 80 cameras, past kernel F's 64,
    with the solve of kernel F' (32-column panels) in place of kernel F's:
    the two schedules agree within the BA tolerance, and the inliers'
    reprojection cost falls below a tenth of the start's."""
    from orbslam2_tpu_torch.kernels import ba_solve_blocked, ba_update_cost
    from orbslam2_tpu_torch.utils.synthetic import ba_window

    cam = Camera.create(520.0, 520.0, 320.0, 240.0, bf=52.0)
    prob = ba.BAProblem(*(torch.from_numpy(a) for a in ba_window(80, 1024, 8)))
    r = ba.optimize_ba_plain(cam, prob, iters=10)
    blocked = ba.PLAIN_STEPS._replace(solve=ba_solve_blocked.ba_solve_blocked_plain)
    rb = ba._schedule(cam, prob, 10, 1, False, blocked)
    np.testing.assert_allclose(rb.poses.numpy(), r.poses.numpy(), atol=1e-4)
    np.testing.assert_allclose(rb.points.numpy(), r.points.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(rb.cost), float(r.cost), rtol=1e-3)
    obs = (prob.point_valid, prob.obs_kf, prob.obs_uvr, prob.obs_sigma2)

    def cost(poses, points):
        return float(ba_update_cost.ba_update_cost_plain(
            cam, poses, points, *obs, prob.obs_valid, r.obs_inlier, False)[1])

    assert cost(rb.poses, rb.points) < 0.1 * cost(prob.poses, prob.points)


def test_gba_on_a_landmark_mesh(closed):
    """``global_bundle_adjustment(use_mesh=True)`` on an 8-shard CPU mesh:
    the gathered problem, padded to divide by the mesh, is solved by
    ``parallel.sharded_ba`` (not the single-device schedule), its poses and
    points are written back, and the map reprojects at sub-pixel medians.
    Not compared at tight tolerance with the single-device GBA: the
    circle's problem moves by 2e-4 under any change of summation order
    (``test_gba_padded_matches_live_size``)."""
    from orbslam2_tpu_torch.parallel import sharded_ba

    lc, _, _ = closed
    mesh = sharded_ba.make_landmark_mesh(["cpu"] * 8)
    solved = {}
    solve_mesh = lc._gba_solve_mesh

    def record(prob, iters, mesh=None):
        solved["n"] = prob.points.shape[0]
        solved["res"] = solve_mesh(prob, iters, mesh)
        return solved["res"]

    def single(prob, iters):
        raise AssertionError("use_mesh ran the single-device solve")

    lc._gba_solve_mesh, lc._gba_solve = record, single
    try:
        epoch = lc.map.correction_epoch
        lc.global_bundle_adjustment(use_mesh=True, mesh=mesh)
    finally:
        del lc._gba_solve_mesh, lc._gba_solve
    _, kfs, mp_ids, opt_mask, n_ids = lc._gba_gather(None, None, 8)
    res = solved["res"]
    assert res.points.shape[0] % 8 == 0 and res.points.shape[0] >= solved["n"] == n_ids
    assert lc.map.correction_epoch == epoch + 1
    np.testing.assert_array_equal(lc.map.kf_pose[np.asarray(kfs)[opt_mask]],
                                  res.poses.numpy()[opt_mask])
    np.testing.assert_array_equal(lc.map.mp_pos[mp_ids], res.points.numpy()[:n_ids])
    assert max(_reprojection_medians(lc.map, kfs)) < 1.0
