"""End-to-end test of the port's stereo slice on the synthetic box room: the
port's copy of the reference's stereo pipeline test
(``tests/test_slam_e2e.py::TestStereoPipeline``) at its bounds, and the
stereo path's kernels V and W (their plain versions here) on every frame."""

import numpy as np
import pytest
import torch

from orbslam2_tpu_torch import config as tconfig
from orbslam2_tpu_torch.config import CameraConfig, ExtractorConfig, SlamConfig
from orbslam2_tpu_torch.system import SlamSystem
from orbslam2_tpu_torch.utils.evaluation import ate_rmse
from orbslam2_tpu_torch.utils.synthetic import make_box_room, orbit_trajectory, render

torch.set_num_threads(2)

K = np.array([[260.0, 0, 160], [0, 260, 120], [0, 0, 1]], np.float32)
W, H = 320, 240


def stereo_sequence(n=30, bf=52.0):
    """True left/right pairs: the right camera is the left pose shifted by
    the rig baseline along camera +x (bf=52, fx=260 -> b=0.2 m)."""
    b = bf / float(K[0, 0])
    planes = make_box_room(seed=0)
    poses = orbit_trajectory(n)
    Trl = np.eye(4, dtype=np.float32)
    Trl[0, 3] = -b  # right cam: x_r = x_l - b
    pairs = [(render(planes, K, T, W, H), render(planes, K, Trl @ T, W, H))
             for T in poses]
    return pairs, poses


@pytest.fixture(scope="module")
def stereo_pairs():
    return stereo_sequence()


class TestStereoPipeline:
    def test_tracks_and_ate(self, stereo_pairs):
        """Full stereo path: dual extraction, epipolar match + subpixel SAD,
        close-point KF gates, stereo triangulation arbitration."""
        pairs, poses = stereo_pairs
        cfg = SlamConfig(sensor="stereo",
                         camera=CameraConfig(fx=260, fy=260, cx=160, cy=120,
                                             width=W, height=H, bf=52.0, fps=30),
                         extractor=ExtractorConfig(n_features=500, n_levels=4))
        slam = SlamSystem(cfg, device="cpu")
        est, gt = [], []
        for i, ((left, right), Tcw_true) in enumerate(zip(pairs, poses)):
            pose = slam.track_stereo(left, right, i / 30.0)
            if pose is not None:
                est.append(np.linalg.inv(pose)[:3, 3])
                gt.append(np.linalg.inv(Tcw_true)[:3, 3])
        assert len(est) >= len(pairs) - 1, len(est)
        err = ate_rmse(np.array(est), np.array(gt), with_scale=False)
        assert err < 0.045, err  # the reference test's bound
        m = slam.map
        # stereo depth must actually be measured (ur >= 0 on real features)
        kfs = m.valid_keyframes()
        ur = m.kf_ur[kfs]
        frac_stereo = (ur[m.kf_feat_valid[kfs]] >= 0).mean()
        assert frac_stereo > 0.3, frac_stereo
        assert len(kfs) >= 3


def test_slice_parity_with_reference(stereo_pairs):
    """The JAX SlamSystem (loop closing off) and the port run the same 8
    stereo pairs: the same frames are tracked, the same keyframes are made
    from the same frames, the first keyframe's features have a u_right in
    both or in neither for >= 99% of them, and camera centres agree within
    1 cm (float32 rounding differs between the two: the keypoints above
    level 0 differ by a few ulps, ROADMAP queue 3)."""
    from orbslam2_tpu import config as jconfig
    from orbslam2_tpu.system import SlamSystem as JSlamSystem

    pairs = stereo_pairs[0][:8]   # the orbit's poses do not depend on its length

    def cfg(mod):
        return mod.SlamConfig(sensor="stereo",
                              camera=mod.CameraConfig(fx=260, fy=260, cx=160, cy=120,
                                                      width=W, height=H, bf=52.0, fps=30),
                              extractor=mod.ExtractorConfig(n_features=500, n_levels=4))

    ref = JSlamSystem(cfg(jconfig), enable_loop_closing=False)
    port = SlamSystem(cfg(tconfig), enable_loop_closing=False, device="cpu")
    for i, (left, right) in enumerate(pairs):
        pj = ref.track_stereo(left, right, i / 30.0)
        pt = port.track_stereo(left, right, i / 30.0)
        assert (pj is None) == (pt is None), i
        if pj is not None:
            cj, ct = np.linalg.inv(pj)[:3, 3], np.linalg.inv(pt)[:3, 3]
            assert np.linalg.norm(cj - ct) < 0.01, (i, cj, ct)
    kj, kt = ref.map.valid_keyframes(), port.map.valid_keyframes()
    np.testing.assert_array_equal(kt, kj)
    np.testing.assert_array_equal(port.map.kf_frame_id[kt], ref.map.kf_frame_id[kj])
    urj, urt = ref.map.kf_ur[0], port.map.kf_ur[0]
    both = (urj >= 0) & (urt >= 0)
    assert both.sum() > 100 and ((urj >= 0) == (urt >= 0)).mean() >= 0.99
