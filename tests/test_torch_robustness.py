"""The port's copies of ``tests/test_tracking_robustness.py``'s keyframe
gates and reset-on-early-loss tests (the relocalization ones are in
``test_torch_reloc.py``; the 80-frame jerky-motion run is a card test in
``test_torch_cuda.py``). The reference's assertions and data unchanged."""

import numpy as np
import torch

from orbslam2_tpu_torch.config import CameraConfig, ExtractorConfig, SlamConfig
from orbslam2_tpu_torch.system import SlamSystem
from orbslam2_tpu_torch.tracking import TrackingState
from orbslam2_tpu_torch.utils.synthetic import render_sequence

torch.set_num_threads(2)

K = np.array([[260.0, 0, 160], [0, 260, 120], [0, 0, 1]], np.float32)


def _cfg():
    return SlamConfig(
        sensor="rgbd",
        camera=CameraConfig(fx=260, fy=260, cx=160, cy=120, width=320,
                            height=240, bf=26.0, fps=30),
        extractor=ExtractorConfig(n_features=500, n_levels=4),
    )


class TestNeedNewKeyFrameGates:
    def test_close_point_urgency(self):
        """<100 tracked close + >70 untracked close forces insertion even
        with a healthy inlier count (bNeedToInsertClose)."""
        frames, _ = render_sequence(6, K, width=320, height=240,
                                    with_depth=True)
        slam = SlamSystem(_cfg(), device="cpu")
        for i, (img, depth) in enumerate(frames):
            slam.track_rgbd(img, depth, i / 30.0)
        tr = slam.tracker
        assert tr.ref_kf >= 0

        class FakeFrame:
            frame_id = tr.last_kf_frame_id + 5
            valid = np.ones(500, bool)
            depth = np.full(500, 0.5, np.float32)  # all close
            mp = np.full(500, -1, np.int64)

        f = FakeFrame()
        f.mp[:50] = 1  # 50 tracked close, 450 untracked close
        tr.n_inliers_last = 200  # healthy by the decay gates alone
        ref_tracked = int((slam.map.kf_mp[tr.ref_kf] >= 0).sum())
        assert tr.n_inliers_last > 0.25 * ref_tracked
        assert tr._need_new_keyframe(f) is True

        # same frame with plenty of tracked close points: no urgency, and
        # a healthy ratio vs the reference KF -> no insertion
        f2 = FakeFrame()
        f2.mp[:] = 1
        tr.n_inliers_last = max(200, int(0.95 * ref_tracked))
        assert tr._need_new_keyframe(f2) is False


class TestResetOnEarlyLoss:
    def test_resets_when_lost_right_after_init(self):
        """Loss with <=5 keyframes discards the bootstrap map entirely
        (Tracking 'Track lost soon after initialisation, reseting...')."""
        frames, _ = render_sequence(3, K, width=320, height=240,
                                    with_depth=True)
        slam = SlamSystem(_cfg(), device="cpu")
        img, depth = frames[0]
        slam.track_rgbd(img, depth, 0.0)
        assert slam.tracking_state == TrackingState.OK
        assert int(slam.map.kf_valid.sum()) >= 1
        blank = np.zeros((240, 320), np.float32)
        slam.track_rgbd(blank, np.zeros((240, 320), np.float32), 1 / 30.0)
        # system was rebuilt: empty map, tracker back to uninitialized
        assert int(slam.map.kf_valid.sum()) == 0
        assert slam.tracking_state in (
            TrackingState.NO_IMAGES_YET, TrackingState.NOT_INITIALIZED)
        # and it can bootstrap again
        for i, (img, depth) in enumerate(frames):
            slam.track_rgbd(img, depth, (2 + i) / 30.0)
        assert slam.tracking_state == TrackingState.OK
