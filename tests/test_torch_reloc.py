"""Relocalization, map persistence and localization mode of the port
(slice 7), against the reference's tests and the JAX package itself.

One module-scoped 25-frame mapped run (the reference's ``mapped_run``
fixture of tests/test_checkpoint_reloc.py) serves the save/load round trip,
the file's round trip through the JAX package, candidate parity of the two
keyframe databases, localization from the saved map, the localization-mode
VO points (tests/test_tracking_robustness.py's data is the same 25 frames)
and one relocalization of both packages on the same frame. The copies of
TestRelocalization and TestHardRelocalization run their own sequences. The
reference's assertions and data are unchanged."""

import numpy as np
import pytest
import torch

from orbslam2_tpu_torch.config import CameraConfig, ExtractorConfig, SlamConfig
from orbslam2_tpu_torch.system import SlamSystem
from orbslam2_tpu_torch.tracking import TrackingState
from orbslam2_tpu_torch.utils.synthetic import render_sequence

torch.set_num_threads(2)

K = np.array([[260.0, 0, 160], [0, 260, 120], [0, 0, 1]], np.float32)


def _cfg(config_mod=None):
    if config_mod is None:
        C, E, S = CameraConfig, ExtractorConfig, SlamConfig
    else:
        C, E, S = config_mod.CameraConfig, config_mod.ExtractorConfig, config_mod.SlamConfig
    return S(sensor="rgbd",
             camera=C(fx=260, fy=260, cx=160, cy=120, width=320, height=240,
                      bf=26.0, fps=30),
             extractor=E(n_features=500, n_levels=4))


@pytest.fixture(scope="module")
def mapped_run(tmp_path_factory):
    """Build a map over 25 frames, save it, return (map_path, frames, poses)."""
    frames, poses = render_sequence(25, K, width=320, height=240, with_depth=True)
    slam = SlamSystem(_cfg(), device="cpu")
    for i, (img, depth) in enumerate(frames):
        slam.track_rgbd(img, depth, i / 30.0)
    path = str(tmp_path_factory.mktemp("maps") / "map.npz")
    slam.save_map(path)
    return path, frames, poses, slam


class TestCheckpoint:
    def test_save_load_roundtrip(self, mapped_run):
        path, frames, poses, slam = mapped_run
        fresh = SlamSystem(_cfg(), device="cpu")
        fresh.load_map(path, localization_only=True)
        m1, m2 = slam.map, fresh.map
        assert m2.n_kf == m1.n_kf and m2.n_mp == m1.n_mp
        np.testing.assert_array_equal(m2.kf_valid, m1.kf_valid)
        np.testing.assert_allclose(m2.mp_pos[: m2.n_mp], m1.mp_pos[: m1.n_mp])
        np.testing.assert_array_equal(m2.kf_mp, m1.kf_mp)
        assert fresh.localization_only

    def test_localization_from_saved_map(self, mapped_run):
        """Relocalize against a loaded map and track without mapping."""
        path, frames, poses, _ = mapped_run
        fresh = SlamSystem(_cfg(), device="cpu")
        fresh.load_map(path, localization_only=True)
        n_kf_before = len(fresh.map.valid_keyframes())
        tracked = 0
        errs = []
        T0 = poses[0]  # map frame is anchored at the first mapped camera
        for i, ((img, depth), T_true) in enumerate(zip(frames[5:20], poses[5:20])):
            pose = fresh.track_rgbd(img, depth, i / 30.0)
            if pose is not None:
                tracked += 1
                C_est = np.linalg.inv(pose)[:3, 3]
                C_gt_map = (T0 @ np.linalg.inv(T_true))[:3, 3]
                errs.append(np.linalg.norm(C_est - C_gt_map))
        assert tracked >= 10, tracked
        assert np.median(errs) < 0.1
        # localization-only: the map must not have grown
        assert len(fresh.map.valid_keyframes()) == n_kf_before


def _jax_load(path):
    """The JAX package's map and keyframe database read from ``path``."""
    from orbslam2_tpu import config as jconfig
    from orbslam2_tpu.map.keyframe_database import KeyFrameDatabase as JKfdb
    from orbslam2_tpu.map.state import MapState as JMapState
    from orbslam2_tpu.utils.checkpoint import load_map as jload

    jcfg = _cfg(jconfig)
    jkfdb = JKfdb(JMapState.allocate(jcfg))
    return jload(path, jcfg, jkfdb), jkfdb, jcfg


def test_checkpoint_moves_between_packages(mapped_run, tmp_path):
    """The JAX package's load_map reads the port's file and its save_map
    writes it again; the port loads that file, and every array of the map
    and of the keyframe database equals the original."""
    from orbslam2_tpu.utils.checkpoint import save_map as jsave

    path, _, _, slam = mapped_run
    jm, jkfdb, _ = _jax_load(path)
    path2 = str(tmp_path / "via_jax.npz")
    jsave(path2, jm, jkfdb)
    fresh = SlamSystem(_cfg(), device="cpu")
    fresh.load_map(path2)
    with np.load(path) as a, np.load(path2) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    for name, value in vars(slam.map).items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(getattr(fresh.map, name), value, err_msg=name)
    for name in ("bow_mat", "in_db", "vocab", "idf"):
        np.testing.assert_array_equal(getattr(fresh.kfdb, name),
                                      getattr(slam.kfdb, name), err_msg=name)
    assert slam.kfdb.in_db.sum() >= 3


def test_relocalization_candidates_match_reference(mapped_run):
    """On the same loaded map, for the same query frames, the JAX
    KeyFrameDatabase and the port's (converted from it by
    utils/convert.py) return equal candidate lists; the query vectors agree
    within 1e-6 relative."""
    from orbslam2_tpu_torch.ops.orb import OrbExtractor
    from orbslam2_tpu_torch.utils.convert import (keyframe_database_from_numpy,
                                                  map_state_from_numpy)

    path, frames, _, _ = mapped_run
    jm, jkfdb, _ = _jax_load(path)
    cfg = _cfg()
    m = map_state_from_numpy(cfg, {f: getattr(jm, f) for f in (
        "kf_valid", "kf_desc", "kf_feat_valid", "covis_idx", "covis_w",
        "kf_mp", "n_kf")}, device="cpu")
    kfdb = keyframe_database_from_numpy(m, dict(
        bow_mat=jkfdb.bow_mat, in_db=jkfdb.in_db, vocab=jkfdb.vocab,
        idf=jkfdb.idf), device="cpu")
    extractor = OrbExtractor(cfg.extractor, 240, 320, device="cpu")
    n_cand = 0
    for i in (3, 12, 21):
        feats = extractor(torch.from_numpy(frames[i][0].astype(np.float32)))
        q = kfdb.compute_bow(feats.desc, feats.valid)
        qj = np.asarray(jkfdb.compute_bow(feats.desc.numpy(), feats.valid.numpy()))
        np.testing.assert_allclose(q, qj, rtol=1e-6, atol=0)
        cand = kfdb.detect_relocalization_candidates(q)
        assert cand == jkfdb.detect_relocalization_candidates(qj), i
        n_cand += len(cand)
    assert n_cand >= 3


class TestLocalizationVOPoints:
    def test_vo_points_augment_and_map_frozen(self, mapped_run):
        """Localization mode spawns temporary VO points from last-frame
        depth (UpdateLastFrame): they appear in the local buffer with
        sel = -1 and the map never grows."""
        path, frames, _, _ = mapped_run
        fresh = SlamSystem(_cfg(), device="cpu")
        fresh.load_map(path, localization_only=True)
        n_mp_before = int(fresh.map.mp_valid.sum())
        n_kf_before = int(fresh.map.kf_valid.sum())
        tracked = 0
        saw_temp = False
        tr = fresh.tracker
        orig = tr._augment_vo_points

        def spy(sel, buf):
            nonlocal saw_temp
            sel2, buf2 = orig(sel, buf)
            if (sel2 < 0).any():
                saw_temp = True
            return sel2, buf2

        tr._augment_vo_points = spy
        for i, (img, depth) in enumerate(frames[3:20]):
            if fresh.track_rgbd(img, depth, i / 30.0) is not None:
                tracked += 1
        assert tracked >= 12, tracked
        assert saw_temp, "VO augmentation never produced temporary points"
        assert int(fresh.map.mp_valid.sum()) == n_mp_before
        assert int(fresh.map.kf_valid.sum()) == n_kf_before


def test_relocalization_slice_parity(mapped_run):
    """Both packages load the same saved map (LOST, localization mode) and
    relocalize on the same frame with the same seed: the same candidate
    becomes the reference keyframe and the poses agree within 1e-3 m."""
    from orbslam2_tpu import config as jconfig
    from orbslam2_tpu.system import SlamSystem as JSlamSystem

    path, frames, _, _ = mapped_run
    ref = JSlamSystem(_cfg(jconfig), enable_loop_closing=False)
    ref.load_map(path, localization_only=True)
    port = SlamSystem(_cfg(), enable_loop_closing=False, device="cpu")
    port.load_map(path, localization_only=True)
    img, depth = frames[14]
    pj = ref.track_rgbd(img, depth, 0.0)
    pt = port.track_rgbd(img, depth, 0.0)
    assert pj is not None and pt is not None
    assert port.tracker.ref_kf == ref.tracker.ref_kf
    cj = np.linalg.inv(pj)[:3, 3]
    ct = np.linalg.inv(pt)[:3, 3]
    assert np.linalg.norm(cj - ct) < 1e-3, (cj, ct)


class TestRelocalization:
    def test_recovers_after_blackout(self):
        """Feed blank frames to force LOST, then real frames to recover."""
        frames, poses = render_sequence(40, K, width=320, height=240,
                                        with_depth=True)
        slam = SlamSystem(_cfg(), device="cpu")
        for i in range(20):
            img, depth = frames[i]
            slam.track_rgbd(img, depth, i / 30.0)
        assert slam.tracking_state == TrackingState.OK
        blank = np.zeros((240, 320), np.float32)
        bdepth = np.zeros((240, 320), np.float32)
        for i in range(3):
            slam.track_rgbd(blank, bdepth, (20 + i) / 30.0)
        assert slam.tracking_state == TrackingState.LOST
        # revisit an already-mapped view
        recovered = False
        for i in range(10, 20):
            img, depth = frames[i]
            pose = slam.track_rgbd(img, depth, (25 + i) / 30.0)
            if pose is not None:
                recovered = True
                C_est = np.linalg.inv(pose)[:3, 3]
                C_gt_map = (poses[0] @ np.linalg.inv(poses[i]))[:3, 3]
                err = np.linalg.norm(C_est - C_gt_map)
                assert err < 0.15, err
                break
        assert recovered, "relocalization failed after blackout"


class TestHardRelocalization:
    def test_relocalizes_from_novel_views(self):
        """Relocalize from views the map has never seen (offset + rotated
        from every mapped pose): the multi-candidate P4P loop and the
        two-stage projection top-up, not just exact-revisit recall."""
        from orbslam2_tpu_torch.utils.synthetic import (make_box_room,
                                                        orbit_trajectory, render)

        planes = make_box_room(seed=0)
        poses = orbit_trajectory(30)
        slam = SlamSystem(_cfg(), device="cpu")
        for i, Tcw in enumerate(poses):
            img, depth = render(planes, K, Tcw, 320, 240, return_depth=True)
            slam.track_rgbd(img, depth, i / 30.0)
        assert slam.tracking_state == TrackingState.OK
        assert int(slam.map.kf_valid.sum()) > 5  # enough KFs to search

        blank = np.zeros((240, 320), np.float32)
        for i in range(3):
            slam.track_rgbd(blank, blank, (30 + i) / 30.0)
        assert slam.tracking_state == TrackingState.LOST

        # novel views: mapped pose perturbed by 12 cm lateral + 4 deg yaw
        yaw = np.deg2rad(4.0)
        Rp = np.array([[np.cos(yaw), 0, np.sin(yaw)],
                       [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]], np.float32)
        recovered = False
        for j, base in enumerate(poses[8:24:4]):
            Twc = np.linalg.inv(base)
            Twc[:3, :3] = Twc[:3, :3] @ Rp
            Twc[:3, 3] += np.array([0.12, 0.03, 0.0], np.float32)
            T_new = np.linalg.inv(Twc).astype(np.float32)
            img, depth = render(planes, K, T_new, 320, 240, return_depth=True)
            pose = slam.track_rgbd(img, depth, (40 + j) / 30.0)
            if pose is not None:
                C_est = np.linalg.inv(pose)[:3, 3]
                C_gt = (poses[0] @ np.linalg.inv(T_new))[:3, 3]
                err = np.linalg.norm(C_est - C_gt)
                assert err < 0.15, err
                recovered = True
                break
        assert recovered, "no novel-view relocalization in 4 attempts"
