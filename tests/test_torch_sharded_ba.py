"""The port's landmark-sharded bundle adjustment
(``orbslam2_tpu_torch.parallel.sharded_ba``) on CPU meshes, where kernels
E-H and shard_reduce run as their plain versions: against the JAX
package's ``make_sharded_ba`` on its 8-device virtual CPU mesh (the
reference test's problem and tolerances), against the one-shard schedule,
and its layout, repeatability and order of summation."""

import numpy as np
import pytest
import torch

import jax

from orbslam2_tpu.parallel import sharded_ba as jsharded
from orbslam2_tpu_torch.kernels import shard_reduce
from orbslam2_tpu_torch.models.camera import Camera
from orbslam2_tpu_torch.ops import ba
from orbslam2_tpu_torch.ops import geometry as tgeo
from orbslam2_tpu_torch.parallel import sharded_ba
from orbslam2_tpu_torch.utils import ba_parity
from orbslam2_tpu_torch.utils.convert import ba_problem_from_numpy, camera_from_numpy
from orbslam2_tpu_torch.utils.synthetic import ba_window
from test_ba import make_ba_problem

torch.set_num_threads(2)


def _port(cam, prob):
    """The reference's camera and BA problem as the port's, on the CPU."""
    tcam = camera_from_numpy({f: np.asarray(getattr(cam, f)) for f in cam._fields})
    return tcam, ba_problem_from_numpy([np.asarray(a) for a in prob], device="cpu")


def _mesh(n):
    return sharded_ba.make_landmark_mesh(["cpu"] * n)


@pytest.fixture(scope="module")
def reference():
    """The reference test's problem (K=6, M=128, two fixed cameras) and the
    JAX package's sharded solve of it on its 8-device virtual mesh: the
    file's one JAX sharded call."""
    cam, prob, *_ = make_ba_problem(np.random.default_rng(0), K=6, M=128,
                                    n_fixed=2)
    mesh = jsharded.make_landmark_mesh(jax.devices()[:8])
    res = jsharded.make_sharded_ba(mesh, iters=8)(
        cam, jsharded.shard_problem(mesh, prob))
    return cam, prob, jax.tree.map(np.asarray, res)


def test_matches_jax_sharded_ba(reference):
    """The port's 8-shard CPU mesh against the JAX ``make_sharded_ba`` on 8
    virtual devices, within the reference test's tolerances (poses 2e-4,
    points 2e-3, cost 1e-3 relative): the same optimum, the sums in
    another order."""
    cam, prob, jres = reference
    tcam, tprob = _port(cam, prob)
    mesh = _mesh(8)
    res = sharded_ba.make_sharded_ba(mesh, iters=8)(
        tcam, sharded_ba.shard_problem(mesh, tprob))
    np.testing.assert_allclose(res.poses.numpy(), jres.poses, atol=2e-4)
    np.testing.assert_allclose(res.points.numpy(), jres.points, atol=2e-3)
    np.testing.assert_allclose(float(res.cost), float(jres.cost), rtol=1e-3)


def test_one_shard_is_the_plain_schedule(reference):
    """A one-shard mesh runs exactly ``optimize_ba_plain``'s operations (its
    reduction adds one row): the same result bit for bit."""
    tcam, tprob = _port(*reference[:2])
    mesh = _mesh(1)
    res = sharded_ba.make_sharded_ba(mesh, iters=8)(
        tcam, sharded_ba.shard_problem(mesh, tprob))
    ref = ba.optimize_ba_plain(tcam, tprob, iters=8)
    for a, b in zip(res, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [4, 8])
def test_shards_match_one_shard(n):
    """4 and 8 shards of a 24-camera, 1000-landmark window against the
    single-device schedule, within ``ba_parity.LIMITS`` (the kernels'
    limits against the plain schedule: another order of summation)."""
    cam = Camera.create(520.0, 520.0, 320.0, 240.0, bf=52.0)
    prob = ba.BAProblem(*(torch.from_numpy(a) for a in ba_window(24, 1000, 8)))
    mesh = _mesh(n)
    res = sharded_ba.make_sharded_ba(mesh, iters=10)(
        cam, sharded_ba.shard_problem(mesh, prob))
    got = ba_parity.compare(cam, prob, res, ba.optimize_ba(cam, prob, iters=10))
    assert not ba_parity.over_limits(got), got
    assert (res.poses - prob.poses).abs().max() > 1e-3   # it moved


def test_converges_on_mesh():
    """The reference's ``test_converges_on_mesh`` on the port's 8-shard
    mesh: the optimised cameras within 2e-2 of the truth."""
    cam, prob, poses_true, _, _ = make_ba_problem(
        np.random.default_rng(0), K=6, M=256, n_fixed=2, pose_pert=0.08)
    tcam, tprob = _port(cam, prob)
    mesh = _mesh(8)
    res = sharded_ba.make_sharded_ba(mesh, iters=10)(
        tcam, sharded_ba.shard_problem(mesh, tprob))
    T = res.poses @ tgeo.se3_inverse(torch.from_numpy(poses_true))
    errs = torch.linalg.norm(tgeo.se3_log(T), dim=-1).numpy()
    assert errs[2:].max() < 2e-2, errs


def test_sharding_layout(reference):
    """Each shard holds the cameras and M / n contiguous landmarks on its
    device, the result comes back in the original order, and a landmark
    axis that does not divide by the mesh raises."""
    tcam, tprob = _port(*reference[:2])
    mesh = _mesh(8)
    shards = sharded_ba.shard_problem(mesh, tprob)
    assert len(shards) == mesh.size == 8
    for i, s in enumerate(shards):
        assert s.points.shape == (128 // 8, 3) and s.obs_kf.shape[0] == 16
        assert torch.equal(s.poses, tprob.poses)
        assert torch.equal(s.points, tprob.points[16 * i:16 * (i + 1)])
    res = sharded_ba.make_sharded_ba(mesh, iters=1, outlier_rounds=0)(tcam, shards)
    assert res.points.shape == tprob.points.shape
    with pytest.raises(ValueError, match="divide"):
        sharded_ba.shard_problem(_mesh(3), tprob)


def test_second_call_bit_identical():
    """The same problem solved twice on a 4-shard mesh: the same bits (the
    reduction adds the shards in a fixed order)."""
    cam = Camera.create(520.0, 520.0, 320.0, 240.0, bf=52.0)
    prob = ba.BAProblem(*(torch.from_numpy(a) for a in ba_window(16, 512, 8, seed=3)))
    mesh = _mesh(4)
    fn = sharded_ba.make_sharded_ba(mesh, iters=5)
    a = fn(cam, sharded_ba.shard_problem(mesh, prob))
    b = fn(cam, sharded_ba.shard_problem(mesh, prob))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_shard_reduce_adds_in_shard_order():
    """The plain twin of kernel shard_reduce adds the rows in the order 0,
    1, ..., n - 1 in float32 (where the order changes the rounding, the
    result is that order's), writing into ``out`` when given."""
    x = torch.tensor([[1e8, 1.0, 3.0], [1.0, 1e-8, -1e8], [-1e8, 2.0, 1e8],
                      [1.0, -3.0, 1.0]], dtype=torch.float32)
    want = x[0].clone()
    for row in x[1:]:
        want = want + row
    assert torch.equal(shard_reduce.shard_reduce(x), want)
    assert not torch.equal(want, x.flip(0).cumsum(0)[-1])   # the order matters
    out = torch.empty(3)
    assert shard_reduce.shard_reduce(x, out) is out and torch.equal(out, want)
    assert torch.equal(shard_reduce.shard_reduce(x[:1]), x[0])
