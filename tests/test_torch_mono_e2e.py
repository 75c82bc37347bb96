"""End-to-end tests of the port's monocular slice on the synthetic box room:
the port's copies of the reference's monocular pipeline tests
(``tests/test_slam_e2e.py::TestMonoPipeline``) at their bounds; the
initialisation runs SearchForInitialization (kernel U) and the two-view
initializer (kernel X), their plain versions here."""

import numpy as np
import pytest
import torch

from orbslam2_tpu_torch.config import CameraConfig, ExtractorConfig, SlamConfig
from orbslam2_tpu_torch.system import SlamSystem
from orbslam2_tpu_torch.tracking import TrackingState
from orbslam2_tpu_torch.utils.evaluation import ate_rmse
from orbslam2_tpu_torch.utils.synthetic import render_sequence

torch.set_num_threads(2)

K = np.array([[260.0, 0, 160], [0, 260, 120], [0, 0, 1]], np.float32)
W, H = 320, 240


def _cfg():
    return SlamConfig(sensor="monocular",
                      camera=CameraConfig(fx=260, fy=260, cx=160, cy=120, width=W,
                                          height=H, bf=0.0, fps=30),
                      extractor=ExtractorConfig(n_features=500, n_levels=4))


@pytest.fixture(scope="module")
def mono_sequence():
    return render_sequence(50, K, width=W, height=H, with_depth=False)


class TestMonoPipeline:
    def test_initializes_and_tracks(self, mono_sequence):
        frames, poses = mono_sequence
        slam = SlamSystem(_cfg(), device="cpu")
        est, gt = [], []
        for i, (img, Tcw_true) in enumerate(zip(frames, poses)):
            pose = slam.track_monocular(img, i / 30.0)
            if pose is not None:
                est.append(np.linalg.inv(pose)[:3, 3])
                gt.append(np.linalg.inv(Tcw_true)[:3, 3])
        assert len(est) >= 25  # initialized within the parallax budget
        err = ate_rmse(np.array(est), np.array(gt), with_scale=True)
        assert err < 0.035, err  # the reference test's bound
        assert slam.tracking_state == TrackingState.OK
        # a map without depth: no keyframe feature has u_right
        m = slam.map
        kfs = m.valid_keyframes()
        assert len(kfs) >= 2 and (m.kf_ur[kfs] < 0).all()

    def test_reset(self, mono_sequence):
        frames, _ = mono_sequence
        slam = SlamSystem(_cfg(), device="cpu")
        for i, img in enumerate(frames[:12]):
            slam.track_monocular(img, i / 30.0)
        slam.reset()
        assert slam.tracking_state == TrackingState.NO_IMAGES_YET
        assert len(slam.map.valid_keyframes()) == 0
        # can re-run after reset
        for i, img in enumerate(frames[:5]):
            slam.track_monocular(img, i / 30.0)


def test_slice_parity_with_reference(mono_sequence):
    """The JAX SlamSystem (loop closing off) and the port run the same 6
    frames: the initialisation happens at the same frame from the same
    minimal sets (both draw them from runtime.seed), with the same model,
    nearly the same map points, and camera centres within 1 cm of the
    scale-normalized map (the port solves the initializer's normal
    equations in float64, the reference in float32)."""
    from orbslam2_tpu import config as jconfig
    from orbslam2_tpu.system import SlamSystem as JSlamSystem

    frames, _ = mono_sequence
    c = _cfg()
    jcfg = jconfig.SlamConfig(
        sensor="monocular",
        camera=jconfig.CameraConfig(fx=260, fy=260, cx=160, cy=120, width=W,
                                    height=H, bf=0.0, fps=30),
        extractor=jconfig.ExtractorConfig(n_features=500, n_levels=4))
    ref = JSlamSystem(jcfg, enable_loop_closing=False)
    port = SlamSystem(c, enable_loop_closing=False, device="cpu")
    for i, img in enumerate(frames[:6]):
        pj = ref.track_monocular(img, i / 30.0)
        pt = port.track_monocular(img, i / 30.0)
        assert (pj is None) == (pt is None), i
        if pj is not None:
            cj, ct = np.linalg.inv(pj)[:3, 3], np.linalg.inv(pt)[:3, 3]
            assert np.linalg.norm(cj - ct) < 0.01, (i, cj, ct)
    kj, kt = ref.map.valid_keyframes(), port.map.valid_keyframes()
    np.testing.assert_array_equal(port.map.kf_frame_id[kt], ref.map.kf_frame_id[kj])
    nj, nt = len(ref.map.valid_map_points()), len(port.map.valid_map_points())
    assert nj > 50 and abs(nt - nj) <= max(2, 0.02 * nj), (nt, nj)
