"""The port's bundle adjustment on CPU tensors, where ``optimize_ba`` runs
the plain versions of kernels E-H: the cases of the reference's
``tests/test_ba.py``, the local mapper's chunked resume, and parity with
the JAX ``optimize_ba`` on seeded problems (a camera without observations,
invalid landmarks, forced LM rejects), at K <= 16 and M <= 1024."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from orbslam2_tpu.models.camera import Camera as JCamera
from orbslam2_tpu.ops import ba as jba
from orbslam2_tpu_torch.models.camera import Camera as TCamera
from orbslam2_tpu_torch.ops import ba as tba
from orbslam2_tpu_torch.ops import geometry as tgeo
from orbslam2_tpu_torch.utils import ba_parity
from orbslam2_tpu_torch.utils.synthetic import ba_window
from test_ba import make_ba_problem

torch.set_num_threads(2)


def _port(cam, prob):
    """The reference's camera and problem as the port's, through numpy."""
    tcam = TCamera.create(float(cam.fx), float(cam.fy), float(cam.cx),
                          float(cam.cy), bf=float(cam.bf))
    return tcam, tba.BAProblem(*(torch.from_numpy(np.array(a)) for a in prob))


def _pose_errors(poses, poses_true):
    T = poses @ tgeo.se3_inverse(torch.from_numpy(poses_true))
    return torch.linalg.norm(tgeo.se3_log(T), dim=-1).numpy()


def _assert_parity(rt, rj):
    """float32 LM with sums in another order than XLA's: poses agree to
    1e-4 (rotation entries, metres) and points, 6-12 m away, to 1e-4
    relative; the inlier classification may flip only at chi2 boundaries,
    in at most 0.1% of the slots; the cost to 1e-3 relative."""
    np.testing.assert_allclose(rt.poses.numpy(), np.asarray(rj.poses), atol=1e-4)
    np.testing.assert_allclose(rt.points.numpy(), np.asarray(rj.points),
                               rtol=1e-4, atol=1e-4)
    assert (rt.obs_inlier.numpy() != np.asarray(rj.obs_inlier)).mean() <= 0.001
    np.testing.assert_allclose(float(rt.cost), float(rj.cost), rtol=1e-3)


class TestBA:
    """The reference's tests/test_ba.py cases on the port, same bounds."""

    def test_converges_mono(self, rng):
        cam, prob, poses_true, pts_true, _ = make_ba_problem(rng, n_fixed=2)
        cam, prob = _port(cam, prob)
        res = tba.optimize_ba(cam, prob, iters=10)
        errs = _pose_errors(res.poses, poses_true)
        assert errs[2:].max() < 2e-2, errs
        # fixed cameras untouched
        np.testing.assert_allclose(res.poses[:2].numpy(), poses_true[:2], atol=1e-7)
        pt_err = np.linalg.norm(res.points.numpy() - pts_true, axis=1)
        assert np.median(pt_err) < 0.05
        n_obs = int(prob.obs_valid.sum())
        assert float(res.cost) < 3.0 * (2 * 0.3 ** 2) * n_obs

    def test_converges_stereo(self, rng):
        cam, prob, poses_true, _, _ = make_ba_problem(rng, stereo=True)
        res = tba.optimize_ba(*_port(cam, prob), iters=10)
        assert _pose_errors(res.poses, poses_true)[1:].max() < 2e-2

    def test_outlier_classification(self, rng):
        cam, prob, poses_true, _, n_out = make_ba_problem(
            rng, outlier_frac=0.1, n_fixed=2)
        cam, prob = _port(cam, prob)
        res = tba.optimize_ba(cam, prob, iters=10)
        assert _pose_errors(res.poses, poses_true)[2:].max() < 2e-2
        inl = res.obs_inlier.numpy()
        first = prob.obs_valid.numpy().argmax(1)
        assert sum(not inl[m, first[m]] for m in range(n_out)) >= 0.9 * n_out

    def test_cost_decreases(self, rng):
        cam, prob, _, _, _ = make_ba_problem(rng, pose_pert=0.1)
        cam, prob = _port(cam, prob)
        res1 = tba.optimize_ba(cam, prob, iters=2)
        res2 = tba.optimize_ba(cam, prob, iters=12)
        assert float(res2.cost) <= float(res1.cost) * 1.01

    def test_motion_only_mode(self, rng):
        """fix_points=True leaves the landmarks untouched."""
        cam, prob, poses_true, _, _ = make_ba_problem(rng, point_pert=0.0)
        cam, prob = _port(cam, prob)
        res = tba.optimize_ba(cam, prob, iters=8, fix_points=True)
        assert torch.equal(res.points, prob.points)
        assert _pose_errors(res.poses, poses_true)[1:].max() < 1e-2

    def test_input_not_modified(self, rng):
        """The schedule updates its own copies of the poses and points."""
        cam, prob, _, _, _ = make_ba_problem(rng)
        cam, prob = _port(cam, prob)
        before = (prob.poses.clone(), prob.points.clone())
        tba.optimize_ba(cam, prob, iters=4)
        assert torch.equal(prob.poses, before[0]) and torch.equal(prob.points, before[1])


def _jax_and_port(cam, prob, **kw):
    rj = jba.optimize_ba(cam, prob, **kw)
    rt = tba.optimize_ba(*_port(cam, prob), **kw)
    return rj, rt


def test_chunked_resume_matches_reference(rng):
    """The local mapper's schedule: 15 iterations as three chunks of 5,
    each resuming from the last chunk's poses and points, the outlier round
    after the last. The port follows the reference chunk by chunk, and the
    Huber cost does not grow from one chunk to the next."""
    cam, prob, poses_true, _, _ = make_ba_problem(rng, K=8, M=256,
                                                  outlier_frac=0.05, n_fixed=2)
    tcam, tprob = _port(cam, prob)
    costs = []
    for chunk in range(3):
        rounds = 1 if chunk == 2 else 0
        rj = jba.optimize_ba(cam, prob, iters=5, outlier_rounds=rounds)
        rt = tba.optimize_ba(tcam, tprob, iters=5, outlier_rounds=rounds)
        _assert_parity(rt, rj)
        prob = prob._replace(poses=rj.poses, points=rj.points)
        tprob = tprob._replace(poses=rt.poses, points=rt.points)
        costs.append(float(rt.cost))
    assert costs[1] <= costs[0] * 1.0001
    assert _pose_errors(tprob.poses, poses_true)[2:].max() < 2e-2


CAM = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, bf=26.0, width=320, height=240)


def _window(K, M, seed):
    """A seeded local-BA window (mono and stereo, camera 0 fixed, perturbed
    start) for the camera above, without gross outliers: an outlier near
    the chi2 threshold may be classified apart in the two packages and then
    moves its point by millimetres, which the point tolerance would not
    cover."""
    return ba_window(K, M, 8, seed, fx=CAM["fx"], cx=CAM["cx"], cy=CAM["cy"],
                     bf=CAM["bf"], outlier_frac=0.0)


def _parity(arrays, **kw):
    rj = jba.optimize_ba(JCamera.create(**CAM),
                         jba.BAProblem(*(jnp.asarray(a) for a in arrays)), **kw)
    rt = tba.optimize_ba(TCamera.create(**CAM),
                         tba.BAProblem(*(torch.from_numpy(np.array(a)) for a in arrays)),
                         **kw)
    _assert_parity(rt, rj)
    return rt


def test_parity_camera_without_observations():
    """An optimised camera that no landmark sees gets a zero step (its block
    is only the damping) in both packages."""
    arrays = _window(16, 1024, 41)
    obs_kf = arrays[4]
    obs_kf[obs_kf == 7] = 3
    rt = _parity(arrays, iters=5, outlier_rounds=1)
    assert torch.equal(rt.poses[7], torch.from_numpy(arrays[0][7]))


def test_parity_invalid_landmarks():
    """Landmarks with point_valid False keep their position and have no
    inlier observation; the rest match the reference."""
    arrays = _window(16, 1024, 42)
    rng = np.random.default_rng(43)
    arrays[3] = rng.random(1024) >= 0.2
    rt = _parity(arrays, iters=5, outlier_rounds=1)
    bad = ~arrays[3]
    assert torch.equal(rt.points[bad], torch.from_numpy(arrays[2][bad]))
    assert not rt.obs_inlier[torch.from_numpy(bad)].any()


@pytest.mark.parametrize("iters,rounds", [(1, 0), (8, 1)])
def test_parity_forced_reject(iters, rounds):
    """A start so far off (0.3 rad / 0.3 m poses, 1 m points) that the
    first LM step raises the cost: both packages reject it (after one
    iteration the poses are the start's), raise lambda x4, and then agree
    on the iterations that follow. Stereo, two fixed cameras: no free
    gauge, so the optimum is unique."""
    cam, prob, _, _, _ = make_ba_problem(np.random.default_rng(4), K=6, M=128,
                                         pose_pert=0.3, point_pert=1.0,
                                         stereo=True, n_fixed=2)
    rj, rt = _jax_and_port(cam, prob, iters=iters, outlier_rounds=rounds)
    moved = (rt.poses.numpy() != np.array(prob.poses)).any()
    assert moved == (iters > 1)
    _assert_parity(rt, rj)


def _solved_window():
    cam = TCamera.create(**CAM)
    prob = tba.BAProblem(*(torch.from_numpy(a) for a in _window(8, 256, 5)))
    return cam, prob, tba.optimize_ba(cam, prob, iters=2, outlier_rounds=0)


def test_ba_parity_equal_results():
    """A result read against itself: every reading is zero, none over its
    limit, and the window's well-observed landmarks all count as
    constrained."""
    cam, prob, res = _solved_window()
    got = ba_parity.compare(cam, prob, res, res)
    assert ba_parity.over_limits(got) == {}
    assert got["loose"] < 0.05 * prob.points.shape[0]
    assert all(v == 0 for k, v in got.items() if k != "loose")


def test_ba_parity_moved_points():
    """A constrained landmark moved by 1e-3 of its distance shows in
    ``points`` and ``reproj`` and goes over both limits; a landmark without
    inlier observations moved by as much is loose: it shows only in
    ``points_all``, and its reprojection shift is zero."""
    cam, prob, ref = _solved_window()
    inlier = ref.obs_inlier.clone()
    inlier[0] = False
    ref = ref._replace(obs_inlier=inlier)
    base = ba_parity.compare(cam, prob, ref, ref)
    pts = ref.points.clone()
    pts[0] *= 1.001
    got = ba_parity.compare(cam, prob, ref._replace(points=pts), ref)
    assert got["loose"] == base["loose"] >= 1
    assert got["points"] == 0 and got["reproj"] == 0
    assert got["points_all"] == pytest.approx(1e-3, rel=1e-3)
    pts[1] *= 1.001
    got = ba_parity.compare(cam, prob, ref._replace(points=pts), ref)
    assert got["points"] == pytest.approx(1e-3, rel=1e-3)
    assert set(ba_parity.over_limits(got)) == {"points", "reproj"}
