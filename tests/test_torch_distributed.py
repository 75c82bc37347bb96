"""The port's multi-process sharded BA (``parallel/distributed.py`` through
``parallel/smoke_worker.py``): two ``gloo`` ranks on the CPU, each a process
holding one landmark shard, against the two-shard in-process mesh.

The ranks meet by a ``file://`` rendezvous under the test's own directory
(no TCP port: several test workers run at once); each rendezvous and
collective waits at most 60 s, each worker at most 120 s."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from orbslam2_tpu.models.camera import Camera as JCamera
from orbslam2_tpu.ops import ba as jba
from orbslam2_tpu_torch.ops import ba
from orbslam2_tpu_torch.parallel import sharded_ba, smoke_worker
from orbslam2_tpu_torch.utils import ba_parity
from orbslam2_tpu_torch.utils.convert import ba_problem_from_numpy, camera_from_numpy
from test_ba import make_ba_problem

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def solved(tmp_path_factory):
    """Two ranks solve the reference's two-process problem (K=6, M=128),
    once for the module: the reference's camera and problem, and each
    rank's output file."""
    tmp_path = tmp_path_factory.mktemp("gloo")
    cam, prob, *_ = make_ba_problem(np.random.default_rng(0), K=6, M=128,
                                    n_fixed=2)
    payload = {f"cam_{f}": np.asarray(getattr(cam, f)) for f in JCamera._fields}
    payload.update({f"prob_{f}": np.asarray(getattr(prob, f))
                    for f in jba.BAProblem._fields})
    prob_npz, out_npz = tmp_path / "prob.npz", tmp_path / "out.npz"
    np.savez(prob_npz, **payload)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "orbslam2_tpu_torch.parallel.smoke_worker",
         str(rank), "2", f"file://{tmp_path / 'rendezvous'}", str(prob_npz),
         str(out_npz), "--device", "cpu"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            outs.append((p.returncode, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rc, err in outs:
        assert rc == 0, f"worker failed rc={rc}\n{err[-3000:]}"
    ranks = [dict(np.load(smoke_worker.out_path(str(out_npz), r)))
             for r in range(2)]
    return payload, prob, ranks


def test_each_rank_reports_the_world(solved):
    """Rank 0 writes ``out.npz``, rank 1 ``out.rank1.npz``, each with the
    group's size and its own block of the landmarks."""
    _, prob, ranks = solved
    assert [int(r["world"]) for r in ranks] == [2, 2]
    M = np.asarray(prob.points).shape[0]
    assert [r["points"].shape for r in ranks] == [(M // 2, 3)] * 2


def test_ranks_hold_the_same_poses_and_cost(solved):
    """The all-reduce gives every rank one sum, so both ranks hold the
    same poses and cost bit for bit."""
    _, _, ranks = solved
    assert np.array_equal(ranks[0]["poses"], ranks[1]["poses"])
    assert float(ranks[0]["cost"]) == float(ranks[1]["cost"])


def test_two_gloo_ranks_match_the_in_process_mesh(solved):
    """The two ranks' result agrees with the two-shard in-process mesh
    within ``ba_parity.LIMITS`` (sums in another order)."""
    payload, prob, ranks = solved
    got = ba.BAResult(
        poses=torch.from_numpy(ranks[0]["poses"]),
        points=torch.from_numpy(np.concatenate([r["points"] for r in ranks])),
        obs_inlier=torch.from_numpy(np.concatenate([r["obs_inlier"] for r in ranks])),
        cost=torch.tensor(float(ranks[0]["cost"])))

    tcam = camera_from_numpy({f: payload[f"cam_{f}"] for f in JCamera._fields})
    tprob = ba_problem_from_numpy([np.asarray(a) for a in prob], device="cpu")
    mesh = sharded_ba.make_landmark_mesh(["cpu"] * 2)
    ref = sharded_ba.make_sharded_ba(mesh, iters=8)(
        tcam, sharded_ba.shard_problem(mesh, tprob))
    readings = ba_parity.compare(tcam, tprob, got, ref)
    assert not ba_parity.over_limits(readings), readings
