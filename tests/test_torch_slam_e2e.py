"""End-to-end tests of the port's RGB-D slice on the synthetic box room:
(a) the port's copy of the reference's RGB-D pipeline test at its bounds,
(b) parity of whole runs against the JAX SlamSystem, and (c) the port
imports no JAX."""

import os
import subprocess
import sys

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
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(config_mod=None):
    """The reference e2e test's RGB-D configuration (tests/test_slam_e2e.py),
    built from either package's config module."""
    if config_mod is None:
        C, E, S = CameraConfig, ExtractorConfig, SlamConfig
    else:
        C, E, S = config_mod.CameraConfig, config_mod.ExtractorConfig, config_mod.SlamConfig
    return S(sensor="rgbd",
             camera=C(fx=260, fy=260, cx=160, cy=120, width=W, height=H,
                      bf=26.0, fps=30),
             extractor=E(n_features=500, n_levels=4))


@pytest.fixture(scope="module")
def rgbd_sequence():
    return render_sequence(36, K, width=W, height=H, with_depth=True)


class TestRgbdPipeline:
    def test_tracks_and_ate(self, rgbd_sequence):
        frames, poses = rgbd_sequence
        slam = SlamSystem(_cfg(), device="cpu")
        est, gt = [], []
        for i, ((img, depth), Tcw_true) in enumerate(zip(frames, poses)):
            pose = slam.track_rgbd(img, depth, i / 30.0)
            if pose is not None:
                est.append(np.linalg.inv(pose)[:3, 3])
                gt.append(np.linalg.inv(Tcw_true)[:3, 3])
        assert len(est) == len(frames)  # never lost
        err = ate_rmse(np.array(est), np.array(gt), with_scale=False)
        assert err < 0.035, err  # the reference test's bound
        assert slam.tracking_state == TrackingState.OK
        m = slam.map
        assert len(m.valid_keyframes()) >= 3
        assert len(m.valid_map_points()) > 300
        # observation invariants: every kf_mp entry points to a live point
        for kf in m.valid_keyframes():
            mps = m.kf_mp[kf][m.kf_mp[kf] >= 0]
            assert m.mp_valid[mps].all()

    def test_trajectory_export(self, rgbd_sequence, tmp_path):
        frames, poses = rgbd_sequence
        slam = SlamSystem(_cfg(), device="cpu")
        for i, (img, depth) in enumerate(frames[:10]):
            slam.track_rgbd(img, depth, i / 30.0)
        tum = tmp_path / "traj.txt"
        kitti = tmp_path / "traj_kitti.txt"
        kf_tum = tmp_path / "kf.txt"
        slam.save_trajectory_tum(str(tum))
        slam.save_trajectory_kitti(str(kitti))
        slam.save_keyframe_trajectory_tum(str(kf_tum))
        lines = tum.read_text().strip().splitlines()
        assert len(lines) == 10
        assert len(lines[0].split()) == 8
        klines = kitti.read_text().strip().splitlines()
        assert len(klines[0].split()) == 12
        # the exported quaternion/translation is the tracked pose
        vals = np.array(lines[-1].split(), float)
        Twc = np.linalg.inv(slam.trajectory()[-1][2])
        np.testing.assert_allclose(vals[1:4], Twc[:3, 3], atol=1e-6)
        assert len(kf_tum.read_text().strip().splitlines()) == \
            len(slam.map.valid_keyframes())

    def test_unported_paths_raise(self, rgbd_sequence, monkeypatch, capsys):
        img = rgbd_sequence[0][0][0]
        # loop closing is ported (slices 8 and 8b) and on by default; past
        # the reference's largest single solves, global BA over 257 live
        # keyframes enters the overlapping-window sweep (windows of 256,
        # overlap 64: two windows) ...
        closer = SlamSystem(_cfg(), device="cpu").loop_closer
        assert closer is not None
        closer.map.kf_valid[:257] = True
        closer.map.n_kf = 257
        sweeps = []
        sweep = closer._gba_sweep
        monkeypatch.setattr(closer, "_gba_sweep",
                            lambda *a, **k: sweeps.append(k) or sweep(*a, **k))
        closer.global_bundle_adjustment()
        assert sweeps == [dict(window=256, max_points=32768, overlap=64)]
        assert "sweep: 257 KFs in 2 windows of 256 (overlap 64)" in \
            capsys.readouterr().out
        # ... and the pose graph past 384 vertices runs the conjugate-
        # gradient solver, one CG solve per LM iteration
        from orbslam2_tpu_torch.ops import pose_graph

        K = pose_graph.DENSE_MAX_K + 1
        S = torch.zeros((K, 8))
        S[:, :2] = 1.0
        e = torch.zeros(1, dtype=torch.int32)
        solves = []
        cg = pose_graph.cg_solve
        monkeypatch.setattr(pose_graph, "cg_solve",
                            lambda *a, **k: solves.append(1) or cg(*a, **k))
        res = pose_graph.optimize_pose_graph(
            S, torch.zeros(K, dtype=torch.bool), torch.ones(K, dtype=torch.bool),
            e, e + 1, S[:1], torch.ones(1, dtype=torch.bool))
        assert len(solves) == 20
        assert res.poses.shape == (K, 8) and torch.isfinite(res.poses).all()
        # stereo and monocular are ported (slice 6): a first frame runs
        for sensor in ("monocular", "stereo"):
            cfg = _cfg()
            cfg.sensor = sensor
            other = SlamSystem(cfg, device="cpu")
            if sensor == "stereo":
                other.track_stereo(img, img, 0.0)
            else:
                assert other.track_monocular(img, 0.0) is None
            assert other.tracking_state != TrackingState.NO_IMAGES_YET
        # pipelined tracking is ported (slice 9): a first frame initializes
        # through it; the mesh solves (slice 10) still raise
        slam = SlamSystem(_cfg(), device="cpu")
        depth = rgbd_sequence[0][0][1]
        assert slam.tracker.track_pipelined(img, 0.0, depth_map=depth) is not None
        assert slam.tracking_state == TrackingState.OK
        with pytest.raises(NotImplementedError, match="slice 10"):
            closer.global_bundle_adjustment(use_mesh=True)
        closer.cfg.runtime.mesh_essential_graph = True
        with pytest.raises(NotImplementedError, match="slice 10"):
            closer._optimize_essential_graph(0, 1, {}, {})
        # localization mode is ported (slice 7): it switches the tracker
        slam.activate_localization_mode()
        assert slam.tracker.localization_only


def test_slice_parity_with_reference(rgbd_sequence):
    """The JAX SlamSystem (loop closing off) and the port run the same 12
    frames: the same frames are tracked, the same keyframe ids are made
    from the same frames, and camera centres agree within 1 cm (float32
    rounding differs between the two, so poses are not bit-identical)."""
    from orbslam2_tpu import config as jconfig
    from orbslam2_tpu.system import SlamSystem as JSlamSystem

    frames, _ = rgbd_sequence
    ref = JSlamSystem(_cfg(jconfig), enable_loop_closing=False)
    port = SlamSystem(_cfg(), enable_loop_closing=False, device="cpu")
    for i, (img, depth) in enumerate(frames[:12]):
        pj = ref.track_rgbd(img, depth, i / 30.0)
        pt = port.track_rgbd(img, depth, i / 30.0)
        assert (pj is None) == (pt is None), i
        if pj is not None:
            cj = np.linalg.inv(pj)[:3, 3]
            ct = np.linalg.inv(pt)[:3, 3]
            assert np.linalg.norm(cj - ct) < 0.01, (i, cj, ct)
    kj = ref.map.valid_keyframes()
    kt = port.map.valid_keyframes()
    np.testing.assert_array_equal(kt, kj)
    np.testing.assert_array_equal(port.map.kf_frame_id[kt], ref.map.kf_frame_id[kj])
    assert len(kj) >= 2


def test_default_device_is_the_card():
    """Without a device argument the port runs on the card; where there is
    none it raises instead of moving to the CPU."""
    from orbslam2_tpu_torch.map.state import MapState
    from orbslam2_tpu_torch.ops.orb import OrbExtractor

    cfg = _cfg()
    makers = (lambda: SlamSystem(cfg), lambda: MapState.allocate(cfg),
              lambda: OrbExtractor(cfg.extractor, H, W))
    for make in makers:
        if torch.cuda.is_available():
            assert torch.device(make().device).type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()


def test_port_never_imports_jax():
    """Importing every module of the port with JAX blocked succeeds, and no
    module file contains an import of jax or of the JAX package."""
    pkg = os.path.join(REPO, "orbslam2_tpu_torch")
    mods = []
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
                mods.append(rel[: -len(".__init__")] if rel.endswith("__init__") else rel)
                src = open(path).read()
                for bad in ("import jax", "from jax", "import orbslam2_tpu\n",
                            "from orbslam2_tpu import", "from orbslam2_tpu."):
                    assert bad not in src, (path, bad)
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'orbslam2_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {sorted(mods)!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k in sys.modules\n"
        "               if sys.modules[k] is not None)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_reads_no_file_of_the_jax_package():
    """No module of the port names a path inside ``orbslam2_tpu/`` (a
    quoted ``"orbslam2_tpu"`` path component), and loading the port's
    assets, with the JAX package blocked, opens no file under it."""
    pkg = os.path.join(REPO, "orbslam2_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(root, f)).read()
                for bad in ('"orbslam2_tpu"', "'orbslam2_tpu'"):
                    assert bad not in src, (f, bad)
    code = (
        "import builtins, io, os, sys\n"
        "for name in ('jax', 'jaxlib', 'orbslam2_tpu'):\n"
        "    sys.modules[name] = None\n"
        "opened = []\n"
        "real_open = builtins.open\n"
        "def spy(file, *a, **k):\n"
        "    opened.append(os.path.abspath(os.fspath(file)))\n"
        "    return real_open(file, *a, **k)\n"
        "builtins.open = io.open = spy\n"
        "from orbslam2_tpu_torch.kernels import describe\n"
        "from orbslam2_tpu_torch.utils.convert import brief_pattern\n"
        "pa, pb = brief_pattern()\n"
        "assert describe._pattern_xy().shape == (512, 2)\n"
        f"bad = [p for p in opened if p.startswith({os.path.join(REPO, 'orbslam2_tpu') + os.sep!r})]\n"
        "assert opened and not bad, (opened, bad)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
