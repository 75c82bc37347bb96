"""The port's dataset surfaces against the JAX package's: loaders, the
runner (``python -m orbslam2_tpu_torch.examples.run_slam``), timestamp
association, EuRoC rectification and the evaluation loaders."""

import os
import subprocess
import sys

import numpy as np
import pytest

from orbslam2_tpu.utils import datasets as jdata
from orbslam2_tpu.utils import evaluation as jeval
from orbslam2_tpu.utils import rectify as jrect
from orbslam2_tpu_torch.utils import datasets as tdata
from orbslam2_tpu_torch.utils import evaluation as teval
from orbslam2_tpu_torch.utils import rectify as trect
from orbslam2_tpu_torch.utils.native_io import write_png
from orbslam2_tpu_torch.utils.synthetic import render_sequence

K = np.array([[260.0, 0, 160], [0, 260, 120], [0, 0, 1]], np.float32)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tum_dir(tmp_path_factory):
    """A TUM fr1-style directory of 12 rendered 320x240 frames (8-bit grey
    PNGs, 16-bit depth), written by the port's writer."""
    d = tmp_path_factory.mktemp("tum_seq")
    frames, poses = render_sequence(12, K, width=320, height=240, with_depth=True)
    tdata.write_tum_rgbd(str(d), frames, poses)
    (d / "settings.yaml").write_text(tdata.settings_yaml(
        260.0, 260.0, 160.0, 120.0, 320, 240, 26.0, 500, 4))
    return d


def test_dataset_loaders_match_reference(tum_dir, tmp_path):
    """TUM RGB-D, TUM mono, KITTI (mono and stereo) and EuRoC (stereo)
    layouts give the reference loaders' arrays exactly."""
    got = list(tdata.tum_rgbd_sequence(str(tum_dir), 5000.0))
    ref = list(jdata.tum_rgbd_sequence(str(tum_dir), 5000.0))
    assert len(got) == len(ref) == 12
    for (ta, ia, da), (tb, ib, db) in zip(got, ref):
        assert ta == tb and ia.dtype == ib.dtype == np.float32
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(da, db)
    assert 0 < got[0][2][got[0][2] > 0].min() < 10  # metres
    for (ta, ia), (tb, ib) in zip(tdata.tum_mono_sequence(str(tum_dir)),
                                  jdata.tum_mono_sequence(str(tum_dir))):
        assert ta == tb
        np.testing.assert_array_equal(ia, ib)

    rng = np.random.default_rng(4)
    imgs = [rng.integers(0, 256, (24, 40)).astype(np.uint8) for _ in range(6)]
    kitti = tmp_path / "kitti"
    tdata.write_kitti(str(kitti), list(zip(imgs[:3], imgs[3:])))
    euroc = tmp_path / "euroc"
    for cam, sub in (("cam0", imgs[:3]), ("cam1", imgs[3:])):
        os.makedirs(euroc / "mav0" / cam / "data")
        for i, img in enumerate(sub):
            write_png(str(euroc / "mav0" / cam / "data" / f"{1403636579763555584 + i * 50000000}.png"), img)
    for stereo in (False, True):
        for a, b in ((tdata.kitti_sequence(str(kitti), stereo),
                      jdata.kitti_sequence(str(kitti), stereo)),
                     (tdata.euroc_sequence(str(euroc), stereo),
                      jdata.euroc_sequence(str(euroc), stereo))):
            a, b = list(a), list(b)
            assert len(a) == len(b) == 3
            for (ta, la, ra), (tb, lb, rb) in zip(a, b):
                assert ta == tb
                np.testing.assert_array_equal(la, lb)
                assert (ra is None) == (rb is None) == (not stereo)
                if stereo:
                    np.testing.assert_array_equal(ra, rb)


def test_euroc_stereo_skips_frames_without_a_right_image(tmp_path):
    """A EuRoC stereo frame whose cam1 image is missing is skipped by the
    port's runner, as the reference's evaluation harness skips it
    (``examples/eval_datasets.py``); the reference runner would hand it to
    ``track_monocular`` on a stereo system (a named divergence). Every other
    frame goes to ``track_stereo`` in order."""
    from orbslam2_tpu_torch.config import SlamConfig
    from orbslam2_tpu_torch.examples import run_slam

    rng = np.random.default_rng(5)
    euroc = tmp_path / "euroc"
    stamps = [1403636579763555584 + i * 50000000 for i in range(5)]
    for cam in ("cam0", "cam1"):
        os.makedirs(euroc / "mav0" / cam / "data")
        for i, ns in enumerate(stamps):
            if cam == "cam1" and i == 2:
                continue
            write_png(str(euroc / "mav0" / cam / "data" / f"{ns}.png"),
                      rng.integers(0, 256, (24, 40)).astype(np.uint8))
    cfg = SlamConfig()
    cfg.sensor = "stereo"

    class Recorder:
        def __init__(self):
            self.calls = []

        def track_stereo(self, left, right, ts):
            assert left.shape == right.shape == (24, 40)
            self.calls.append(("stereo", ts))

        def track_monocular(self, img, ts):
            self.calls.append(("monocular", ts))

    slam, times = Recorder(), []
    run_slam.run_frames("euroc-stereo", str(euroc), cfg, slam, times)
    want = [("stereo", ns * 1e-9) for i, ns in enumerate(stamps) if i != 2]
    assert slam.calls == want and len(times) == 4
    mono = Recorder()
    run_slam.run_frames("euroc-mono", str(euroc), cfg, mono, [])
    assert mono.calls == [("monocular", ns * 1e-9) for ns in stamps]


def test_associate_matches_reference(tum_dir):
    a = tdata._read_tum_list(str(tum_dir / "rgb.txt"))
    b = tdata._read_tum_list(str(tum_dir / "depth.txt"))
    b = [(t + 0.004 * ((i % 3) - 1), p) for i, (t, p) in enumerate(b)][1:]
    for dt in (0.02, 0.003):
        assert tdata.associate(a, b, dt) == jdata.associate(a, b, dt)
    out = subprocess.run(
        [sys.executable, "-m", "orbslam2_tpu_torch.examples.associate",
         str(tum_dir / "rgb.txt"), str(tum_dir / "depth.txt")],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 12 and len(lines[0].split()) == 4


def test_run_slam_cli(tum_dir, tmp_path):
    """The runner on the CPU over 8 frames: TUM-format trajectories."""
    out, kf_out = tmp_path / "traj.txt", tmp_path / "kf.txt"
    proc = subprocess.run(
        [sys.executable, "-m", "orbslam2_tpu_torch.examples.run_slam",
         "tum-rgbd", str(tum_dir / "settings.yaml"), str(tum_dir),
         "--max-frames", "8", "--traj-out", str(out), "--kf-traj-out",
         str(kf_out), "--device", "cpu"],
        capture_output=True, text=True, timeout=600, cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "frames: 8" in proc.stdout and "median tracking time" in proc.stdout
    lines = out.read_text().strip().splitlines()
    assert len(lines) >= 6
    assert all(len(ln.split()) == 8 for ln in lines)
    assert len(kf_out.read_text().strip().splitlines()) >= 1


def test_run_slam_needs_the_card_unless_asked(tum_dir, tmp_path):
    """Without ``--device`` the runner runs on the card, and without one it
    fails: nothing falls back to the CPU."""
    proc = subprocess.run(
        [sys.executable, "-m", "orbslam2_tpu_torch.examples.run_slam",
         "tum-rgbd", str(tum_dir / "settings.yaml"), str(tum_dir),
         "--max-frames", "1", "--traj-out", str(tmp_path / "t.txt")],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    assert not (tmp_path / "t.txt").exists()


def test_rectify_maps_match_reference():
    """The Fusiello rotations and the rectification maps of a converged rig
    with distortion within 1e-5 of the reference's; the remap equal."""
    R = np.array([[0.9998, -0.0100, 0.0150], [0.0101, 0.9999, -0.0020],
                  [-0.0150, 0.0022, 0.9999]])
    u, _, vt = np.linalg.svd(R)
    R = u @ vt
    T = np.array([-0.11, 0.002, -0.001])
    for a, b in zip(trect.rectify_rotations(R, T), jrect.rectify_rotations(R, T)):
        np.testing.assert_allclose(a, b, atol=1e-12)
    Kc = np.array([[458.0, 0, 367.0], [0, 457.0, 248.0], [0, 0, 1]])
    D = np.array([-0.28, 0.07, 2e-4, 2e-5])
    R0, _ = jrect.rectify_rotations(R, T)
    mt = trect.build_rectify_map(Kc, D, R0, Kc, 96, 64)
    mj = jrect.build_rectify_map(Kc, D, R0, Kc, 96, 64)
    for a, b in zip(mt, mj):
        np.testing.assert_allclose(a, b, atol=1e-5)
    img = np.random.default_rng(0).random((64, 96)).astype(np.float32)
    np.testing.assert_array_equal(trect.remap_bilinear(img, *mt),
                                  jrect.remap_bilinear(img, *mj))


def test_euroc_rectify_identity():
    """An aligned, distortion-free rig rectifies to (near) identity maps."""
    R0, R1 = trect.rectify_rotations(np.eye(3), np.array([-0.1, 0.0, 0.0]))
    np.testing.assert_allclose(R0, np.eye(3), atol=1e-12)
    np.testing.assert_allclose(R1, np.eye(3), atol=1e-12)
    Kc = np.array([[100.0, 0, 60], [0, 100.0, 40], [0, 0, 1]])
    mx, my = trect.build_rectify_map(Kc, np.zeros(4), R0, Kc, 120, 80)
    u, v = np.meshgrid(np.arange(120, dtype=np.float32),
                       np.arange(80, dtype=np.float32))
    np.testing.assert_allclose(mx, u, atol=1e-4)
    np.testing.assert_allclose(my, v, atol=1e-4)
    img = np.random.default_rng(0).random((80, 120)).astype(np.float32)
    np.testing.assert_allclose(trect.remap_bilinear(img, mx, my)[:-1, :-1],
                               img[:-1, :-1], atol=1e-3)


def _sensor_yaml(path, cam, T_BS):
    K_, D_ = cam
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(
        "sensor_type: camera\n"
        "T_BS:\n  cols: 4\n  rows: 4\n  data: [" + ", ".join(f"{x:.12g}" for x in T_BS.ravel())
        + "]\nrate_hz: 20\nresolution: [96, 64]\ncamera_model: pinhole\n"
        f"intrinsics: [{K_[0, 0]}, {K_[1, 1]}, {K_[0, 2]}, {K_[1, 2]}]\n"
        "distortion_model: radial-tangential\n"
        "distortion_coefficients: [" + ", ".join(str(x) for x in D_) + "]\n")


def test_rectifiers_match_reference(tmp_path):
    """EurocRectifier from mav0/cam*/sensor.yaml and YamlRectifier from the
    settings' LEFT./RIGHT. blocks: maps within 1e-5 of the reference's."""
    from orbslam2_tpu.config import load_config as jload
    from orbslam2_tpu_torch.config import load_config as tload

    Kc = np.array([[150.0, 0, 48.0], [0, 150.0, 32.0], [0, 0, 1.0]])
    D = np.array([-0.28, 0.07, 1e-4, 2e-5])
    T0 = np.eye(4)
    T1 = np.eye(4)
    T1[:3, 3] = [0.11, -0.002, 0.001]
    _sensor_yaml(tmp_path / "seq" / "mav0" / "cam0" / "sensor.yaml", (Kc, D), T0)
    _sensor_yaml(tmp_path / "seq" / "mav0" / "cam1" / "sensor.yaml", (Kc, D), T1)
    a = trect.EurocRectifier(str(tmp_path / "seq"), Kc, 96, 64)
    b = jrect.EurocRectifier(str(tmp_path / "seq"), Kc, 96, 64)
    assert a.baseline == b.baseline
    for ma, mb in zip(a.map0 + a.map1, b.map0 + b.map1):
        np.testing.assert_allclose(ma, mb, atol=1e-5)

    P = np.array([[140.0, 0, 48, 0], [0, 140.0, 32, 0], [0, 0, 1.0, 0]])

    def block(name, M):
        rows, cols = M.shape
        data = ", ".join(f"{x:.12g}" for x in M.ravel())
        return (f"{name}: !!opencv-matrix\n   rows: {rows}\n   cols: {cols}\n"
                f"   dt: d\n   data: [{data}]\n")

    y = tmp_path / "euroc_raw.yaml"
    y.write_text(
        tdata.settings_yaml(140.0, 140.0, 48.0, 32.0, 96, 64, 14.0, 500, 4)
        + "LEFT.width: 96\nLEFT.height: 64\nRIGHT.width: 96\nRIGHT.height: 64\n"
        + block("LEFT.K", Kc) + block("LEFT.D", D.reshape(1, 4))
        + block("LEFT.R", np.eye(3)) + block("LEFT.P", P)
        + block("RIGHT.K", Kc) + block("RIGHT.D", D.reshape(1, 4))
        + block("RIGHT.R", np.eye(3)) + block("RIGHT.P", P))
    ra = trect.YamlRectifier(tload(str(y), sensor="stereo").stereo_rectify)
    rb = jrect.YamlRectifier(jload(str(y), sensor="stereo").stereo_rectify)
    for ma, mb in zip(ra.map0 + ra.map1, rb.map0 + rb.map1):
        np.testing.assert_allclose(ma, mb, atol=1e-5)
    img = np.random.default_rng(1).random((64, 96)).astype(np.float32)
    for oa, ob in zip(ra(img, img), rb(img, img)):
        np.testing.assert_array_equal(oa, ob)


def test_evaluation_loaders_match_reference(tmp_path):
    """TUM ground truth and trajectories, KITTI poses and EuRoC ground truth
    read as the reference reads them; association and ATE agree."""
    rng = np.random.default_rng(2)
    n = 40
    ts = 1000.0 + np.arange(n) / 30.0
    xyz = np.cumsum(rng.normal(0, 0.01, (n, 3)), 0)
    (tmp_path / "gt.txt").write_text("# ts tx ty tz qx qy qz qw\n" + "".join(
        f"{t:.6f} {p[0]:.7f} {p[1]:.7f} {p[2]:.7f} 0 0 0 1\n" for t, p in zip(ts, xyz)))
    rows = np.concatenate([np.tile(np.eye(3), (n, 1, 1)), xyz[:, :, None]], 2)
    np.savetxt(tmp_path / "00.txt", rows.reshape(n, 12))
    (tmp_path / "data.csv").write_text("#timestamp,p_x,p_y,p_z,q_w\n" + "".join(
        f"{int(t * 1e9)},{p[0]},{p[1]},{p[2]},1\n" for t, p in zip(ts, xyz)))
    for name in ("load_tum_groundtruth", "load_tum_trajectory"):
        for a, b in zip(getattr(teval, name)(str(tmp_path / "gt.txt")),
                        getattr(jeval, name)(str(tmp_path / "gt.txt"))):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(teval.load_kitti_poses(str(tmp_path / "00.txt")),
                                  jeval.load_kitti_poses(str(tmp_path / "00.txt")))
    for a, b in zip(teval.load_euroc_groundtruth(str(tmp_path / "data.csv")),
                    jeval.load_euroc_groundtruth(str(tmp_path / "data.csv"))):
        np.testing.assert_array_equal(a, b)
    t_est = ts[::2] + rng.normal(0, 0.004, n // 2)
    for dt in (0.02, 0.005):
        for a, b in zip(teval.associate_trajectories(t_est, ts, dt),
                        jeval.associate_trajectories(t_est, ts, dt)):
            np.testing.assert_array_equal(a, b)
    ia, ib = teval.associate_trajectories(t_est, ts)
    est = xyz[ib] + rng.normal(0, 0.002, (len(ib), 3))
    assert teval.ate_rmse(est, xyz[ib], False) == jeval.ate_rmse(est, xyz[ib], False)
