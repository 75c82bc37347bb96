"""The port's asynchronous system on the CPU: pipelined tracking against
the JAX package's, copies of tests/test_pipeline.py's tests, a worker's
failure reaching the caller, the kernel library's locks under threads, and
the warm-up."""

import threading

import numpy as np
import pytest
import torch

from orbslam2_tpu_torch.config import CameraConfig, ExtractorConfig, SlamConfig
from orbslam2_tpu_torch.pipeline import AsyncSlamSystem
from orbslam2_tpu_torch.system import SlamSystem
from orbslam2_tpu_torch.utils.evaluation import ate_rmse
from orbslam2_tpu_torch.utils.synthetic import render_sequence

torch.set_num_threads(2)

K = np.array([[260.0, 0, 160], [0, 260, 120], [0, 0, 1]], np.float32)
W, H = 320, 240


def _cfg(config_mod=None):
    """tests/test_pipeline.py's configuration, from either package."""
    if config_mod is None:
        C, E, S = CameraConfig, ExtractorConfig, SlamConfig
    else:
        C, E, S = config_mod.CameraConfig, config_mod.ExtractorConfig, config_mod.SlamConfig
    return S(sensor="rgbd",
             camera=C(fx=260, fy=260, cx=160, cy=120, width=W, height=H,
                      bf=26.0, fps=30),
             extractor=E(n_features=500, n_levels=4))


@pytest.fixture(scope="module")
def sequence():
    return render_sequence(40, K, width=W, height=H, with_depth=True)


def _ate(slam, poses):
    est = [np.linalg.inv(T)[:3, 3] for _, _, T in slam.tracker.trajectory]
    gt = [np.linalg.inv(poses[f])[:3, 3] for f, _, _ in slam.tracker.trajectory]
    return len(est), ate_rmse(np.array(est), np.array(gt), with_scale=False)


def test_pipelined_tracker_matches_reference(sequence):
    """The JAX and the port's Tracker.track_pipelined over the same 12
    frames (loop closing off), each package's mapper run synchronously on
    the keyframes each call made: the same poses returned (the same lag),
    the same frames tracked, the same keyframe ids made from the same
    frames, camera centres within 1 cm (test_slice_parity_with_reference's
    rules)."""
    from orbslam2_tpu import config as jconfig
    from orbslam2_tpu.system import SlamSystem as JSlamSystem

    frames, _ = sequence
    ref = JSlamSystem(_cfg(jconfig), enable_loop_closing=False)
    port = SlamSystem(_cfg(), enable_loop_closing=False, device="cpu")

    def step(slam, img, depth, ts):
        pose = slam.tracker.track_pipelined(img, ts, depth_map=depth)
        for kf in slam._drain_keyframes():
            slam.local_mapper.process_keyframe(kf)
        return pose

    for i, (img, depth) in enumerate(frames[:12]):
        pj = step(ref, img, depth, i / 30.0)
        pt = step(port, img, depth, i / 30.0)
        assert (pj is None) == (pt is None), i
        assert ref.tracker.pose_lag == port.tracker.pose_lag, i
        if pj is not None:
            cj, ct = np.linalg.inv(pj)[:3, 3], np.linalg.inv(pt)[:3, 3]
            assert np.linalg.norm(cj - ct) < 0.01, (i, cj, ct)
    assert port.tracker.pose_lag == 2  # the default depths commit 2 behind
    for slam in (ref, port):
        slam.tracker.flush_pipeline()
        for kf in slam._drain_keyframes():
            slam.local_mapper.process_keyframe(kf)
    tj, tt = ref.tracker.trajectory, port.tracker.trajectory
    assert [f for f, _, _ in tt] == [f for f, _, _ in tj] == list(range(12))
    for (_, _, Tj), (_, _, Tt) in zip(tj, tt):
        assert np.linalg.norm(np.linalg.inv(Tj)[:3, 3] - np.linalg.inv(Tt)[:3, 3]) < 0.01
    kj, kt = ref.map.valid_keyframes(), port.map.valid_keyframes()
    np.testing.assert_array_equal(kt, kj)
    np.testing.assert_array_equal(port.map.kf_frame_id[kt], ref.map.kf_frame_id[kj])
    assert len(kj) >= 2


def test_async_rgbd_tracks(sequence):
    """tests/test_pipeline.py::test_async_rgbd_tracks on the port."""
    frames, poses = sequence
    slam = AsyncSlamSystem(_cfg(), device="cpu")
    for i, (img, depth) in enumerate(frames[:30]):
        slam.track_rgbd(img, depth, i / 30.0)
    slam.shutdown()  # commits the frames in flight, drains the queues
    n, err = _ate(slam, poses)
    assert n >= 28
    assert err < 0.08, err
    assert len(slam.map.valid_keyframes()) >= 3


def test_elastic_pipeline_depth_bounds_queue_and_keeps_order(sequence):
    """tests/test_pipeline.py's elastic-depth test on the port: with depths
    (1, 4) and copies that claim never to land (a fake whose done() is
    False; result() still returns the packed result), the queue saturates
    at exactly pipeline_depth_max, frames commit in order, and after
    shutdown every tracked frame is in the trajectory in frame order."""
    frames, _ = sequence
    cfg = _cfg()
    cfg.runtime.pipeline_depth = 1
    cfg.runtime.pipeline_depth_max = 4
    slam = AsyncSlamSystem(cfg, device="cpu")
    tr = slam.tracker

    class NeverLands:
        def __init__(self, copy):
            self._copy = copy

        def done(self):
            return False

        def result(self):
            return self._copy.result()

    start_copy, commit = tr._start_copy, tr._commit_pending_one
    committed, depths_seen = [], []

    def logged_commit():
        if tr._pending:
            committed.append(tr._pending[0][0].frame_id)
        return commit()

    tr._start_copy = lambda packed: NeverLands(start_copy(packed))
    tr._commit_pending_one = logged_commit
    try:
        for i, (img, depth) in enumerate(frames):
            slam.track_rgbd(img, depth, i / 30.0)
            depths_seen.append(len(tr._pending))
    finally:
        tr._start_copy, tr._commit_pending_one = start_copy, commit
    assert max(depths_seen) == cfg.runtime.pipeline_depth_max
    assert depths_seen.count(cfg.runtime.pipeline_depth_max) > 10
    assert committed == sorted(committed)
    slam.shutdown()
    fids = [f for f, _, _ in tr.trajectory]
    assert fids == sorted(fids)
    assert len(fids) >= 36


def test_worker_failure_reaches_the_caller(sequence):
    """A failure in the mapping worker is raised on the caller's thread,
    naming the worker and the keyframe: at the next track call, and at
    shutdown(); the worker itself goes on with the next keyframe, as the
    reference's does."""
    import time

    frames, _ = sequence
    slam = AsyncSlamSystem(_cfg(), device="cpu", enable_loop_closing=False)
    for i, (img, depth) in enumerate(frames[:12]):
        slam.track_rgbd(img, depth, i / 30.0)
    mapper = slam.local_mapper
    triangulate = mapper._create_new_points
    # the initialization keyframe: tracking never queues it, so only the
    # rounds queued below reach it, whatever the worker is still doing
    kf = int(slam.map.valid_keyframes()[0])
    assert slam.map.kf_frame_id[kf] == 0
    failures, mapped = [0], []

    def failing(k):
        if k == kf and failures[0]:
            failures[0] -= 1
            raise ValueError("injected failure")
        if k == kf:
            mapped.append(k)
        return triangulate(k)

    mapper._create_new_points = failing
    failures[0] = 1
    slam._kf_queue.put(kf)
    for _ in range(3000):  # the worker reaches the keyframe and fails
        if slam._worker_error is not None:
            break
        time.sleep(0.01)
    img, depth = frames[12]
    with pytest.raises(RuntimeError, match=f"mapping worker failed on keyframe {kf}") as e:
        slam.track_rgbd(img, depth, 12 / 30.0)
    assert isinstance(e.value.__cause__, ValueError)
    failures[0] = 1
    slam._kf_queue.put(kf)  # fails
    slam._kf_queue.put(kf)  # is mapped: the worker goes on
    with pytest.raises(RuntimeError, match=f"mapping worker failed on keyframe {kf}"):
        slam.shutdown()
    assert mapped == [kf]
    assert slam._map_worker is None  # the workers were stopped


def test_gba_failure_reaches_the_caller():
    """The background GBA task's kept failure is raised on the caller's
    thread by shutdown(), once."""
    slam = AsyncSlamSystem(_cfg(), device="cpu")
    slam.loop_closer.gba_error = ValueError("injected failure")
    with pytest.raises(RuntimeError, match="global-BA task failed") as e:
        slam.shutdown()
    assert isinstance(e.value.__cause__, ValueError)
    slam.raise_worker_error()  # raised once


def test_kernel_library_under_threads():
    """Four threads at once: the launch counts (build.count_launch, under
    its lock) lose no increment, and the first-use caches of kernels B and
    I (the BRIEF pattern, the resize taps) are filled once and serve every
    thread the same tables, whose plain versions then agree."""
    from orbslam2_tpu_torch import kernels
    from orbslam2_tpu_torch.kernels import build, describe, hamming, pyramid

    rng = np.random.default_rng(4)
    img = torch.from_numpy(rng.uniform(0, 255, (120, 160)).astype(np.float32))
    describe._pattern_dev.clear()
    for key in [k for k in pyramid._tables if k[0] == (120, 160)]:
        del pyramid._tables[key]
    kernels.reset_launches()
    barrier = threading.Barrier(4)
    out, errors = [None] * 4, []

    def work(i):
        try:
            barrier.wait()
            pat = describe._pattern_on("cpu")
            taps = pyramid._tables_on((120, 160), (100, 133), "cpu")
            level = pyramid.resize_plain(img, (100, 133))
            for _ in range(2000):
                build.count_launch(hamming.__name__)
            out[i] = (pat, taps, level)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors and all(o is not None for o in out)
    assert kernels.launch_counts()["hamming_top2_gated"] == 8000
    assert all(o[0] is out[0][0] and o[1] is out[0][1] for o in out)
    assert all(torch.equal(o[2], out[0][2]) for o in out)
    kernels.reset_launches()


def test_warmup_leaves_the_system_untouched():
    """warmup() runs a frame, a pipelined frame and a keyframe round on a
    scratch map and returns its seconds; the system's own map and tracker
    are as before."""
    slam = SlamSystem(_cfg(), device="cpu")
    seconds = slam.warmup()
    assert seconds > 0
    assert len(slam.map.valid_keyframes()) == 0
    assert slam.tracker.frame_id == 0 and not slam.tracker.trajectory
