"""The port's telemetry (MetricsLog, the tracker's per-frame records, map
snapshots), its HTTP live viewer on a CPU MapState, and its native PNG
decoder (built at first use) and PNG writer."""

import json
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from orbslam2_tpu_torch.config import (CameraConfig, ExtractorConfig,
                                       MapCapacityConfig, SlamConfig)
from orbslam2_tpu_torch.map.state import MapState
from orbslam2_tpu_torch.utils import native_io
from orbslam2_tpu_torch.utils.http_viewer import HttpViewer, build_state
from orbslam2_tpu_torch.utils.telemetry import MetricsLog

torch.set_num_threads(2)


def _fake_slam(n_kf=3, n_mp=50):
    cfg = SlamConfig(
        sensor="monocular",
        camera=CameraConfig(fx=300, fy=300, cx=160, cy=120, width=320,
                            height=240, bf=30.0, fps=30),
        extractor=ExtractorConfig(n_features=64, n_levels=2),
        capacity=MapCapacityConfig(max_keyframes=16, max_map_points=256),
    )
    m = MapState.allocate(cfg, device="cpu")
    rng = np.random.default_rng(0)
    N = cfg.extractor.max_keypoints
    traj = []
    for k in range(n_kf):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = 0.1 * k
        m.add_keyframe(T, np.zeros((N, 2), np.float32), np.zeros((N, 32), np.uint8),
                       np.zeros(N, np.int32), np.zeros(N, np.float32),
                       np.zeros(N, bool), frame_id=k, timestamp=k / 30.0)
        traj.append((k / 30.0, k, T.copy()))
    for _ in range(n_mp):
        p = rng.uniform(-2, 2, 3).astype(np.float32)
        p[2] += 5.0
        m.add_map_point(p, 0)
    return types.SimpleNamespace(map=m, tracker=types.SimpleNamespace(trajectory=traj),
                                 tracking_state="OK")


# ---------------------------------------------------------------------------
# MetricsLog and the tracker's records
# ---------------------------------------------------------------------------

def test_metrics_log_records_timers_and_summary(tmp_path):
    log = MetricsLog(str(tmp_path / "m.jsonl"))
    for i in range(5):
        with log.timer("extract"):
            pass
        log.emit(frame=i, inliers=100 + i, state="OK")
    log.close()
    lines = [json.loads(x) for x in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [r["frame"] for r in lines] == list(range(5))
    assert all("extract" in r["t_ms"] for r in lines)
    s = log.summary()
    assert s["inliers"]["median"] == 102.0 and s["inliers"]["n"] == 5
    assert "state" not in s


@pytest.mark.parametrize("pipelined", [False, True])
def test_commit_emits_a_record_a_frame(tmp_path, pipelined):
    """SlamSystem / AsyncSlamSystem(metrics_path=...) on the CPU: one record
    for every committed frame, from the synchronous commit and from the
    pipelined one."""
    from orbslam2_tpu_torch.pipeline import AsyncSlamSystem
    from orbslam2_tpu_torch.system import SlamSystem
    from orbslam2_tpu_torch.utils.synthetic import render_sequence

    K = np.array([[260.0, 0, 160], [0, 260, 120], [0, 0, 1]], np.float32)
    frames, _ = render_sequence(6, K, width=320, height=240, with_depth=True)
    cfg = SlamConfig(
        sensor="rgbd",
        camera=CameraConfig(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=320,
                            height=240, bf=26.0, fps=30),
        extractor=ExtractorConfig(n_features=500, n_levels=4))
    path = tmp_path / "m.jsonl"
    system = AsyncSlamSystem if pipelined else SlamSystem
    slam = system(cfg, enable_loop_closing=False, device="cpu",
                  metrics_path=str(path))
    for i, (img, depth) in enumerate(frames):
        slam.track_rgbd(img, depth, i / 30.0)
    lagged = slam.tracker.pose_lag
    slam.shutdown()
    recs = [json.loads(x) for x in path.read_text().splitlines()]
    # pipelined, the later frames committed behind their dispatch
    assert (lagged > 0) == pipelined
    assert [r["frame"] for r in recs] == list(range(6))
    assert all(r["state"] == "OK" and r["track_ms"] > 0 for r in recs)
    assert recs[-1]["inliers"] > 50


def test_render_snapshot(tmp_path):
    pytest.importorskip("matplotlib")
    from orbslam2_tpu_torch.utils.telemetry import render_map_snapshot

    slam = _fake_slam()
    render_map_snapshot(slam.map, str(tmp_path / "snap.png"),
                        trajectory=np.zeros((3, 3)), title="t")
    assert native_io.load_image(str(tmp_path / "snap.png")).size > 0


# ---------------------------------------------------------------------------
# The HTTP viewer
# ---------------------------------------------------------------------------

class TestBuildState:
    def test_contents(self):
        st = build_state(_fake_slam())
        assert st["n_keyframes"] == 3 and st["n_map_points"] == 50
        assert len(st["points"]) == 50 and len(st["keyframes"]) == 3
        assert len(st["trajectory"]) == 3
        # the last camera sits at x = 0.2 in Tcw, its centre at -0.2
        assert abs(st["camera"][0] + 0.2) < 1e-6
        json.dumps(st)

    def test_downsampling_cap(self):
        st = build_state(_fake_slam(n_mp=100), max_points=30)
        assert st["n_map_points"] == 100
        assert len(st["points"]) <= 50


class TestHttpViewer:
    def test_serves_page_and_state(self):
        slam = _fake_slam()
        viewer = HttpViewer(slam, port=0, interval=0.0)
        try:
            base = f"http://127.0.0.1:{viewer.port}"
            page = urllib.request.urlopen(f"{base}/", timeout=10).read()
            assert b"orbslam2_tpu_torch" in page and b"state.json" in page
            st = json.loads(urllib.request.urlopen(f"{base}/state.json",
                                                   timeout=10).read())
            assert st["n_keyframes"] == 3 and st["tracking_state"] == "OK"
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(f"{base}/etc/passwd", timeout=10)
            assert e.value.code == 404
        finally:
            viewer.stop()

    def test_state_cache_refreshes(self):
        slam = _fake_slam()
        viewer = HttpViewer(slam, port=0, interval=0.0)
        try:
            base = f"http://127.0.0.1:{viewer.port}"
            st0 = json.loads(urllib.request.urlopen(f"{base}/state.json",
                                                    timeout=10).read())
            slam.map.add_map_point(np.float32([1, 1, 6]), 0)
            st1 = json.loads(urllib.request.urlopen(f"{base}/state.json",
                                                    timeout=10).read())
            assert st1["n_map_points"] == st0["n_map_points"] + 1
        finally:
            viewer.stop()


# ---------------------------------------------------------------------------
# Native PNG decoding and the PNG writer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def png_files(tmp_path_factory):
    """gray8 and gray16 written by the stdlib writer and by PIL, and an RGB
    PNG by PIL, with the arrays they hold."""
    from PIL import Image

    rng = np.random.default_rng(0)
    d = tmp_path_factory.mktemp("pngs")
    g8 = rng.integers(0, 256, size=(48, 64)).astype(np.uint8)
    g16 = rng.integers(0, 65535, size=(32, 40)).astype(np.uint16)
    native_io.write_png(str(d / "gray8.png"), g8)
    native_io.write_png(str(d / "gray16.png"), g16)
    Image.fromarray(g8, "L").save(d / "gray8_pil.png")
    Image.fromarray(g16).save(d / "gray16_pil.png")
    rgb = rng.integers(0, 256, size=(20, 30, 3)).astype(np.uint8)
    Image.fromarray(rgb, "RGB").save(d / "rgb.png")
    gray = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    return {"gray8": (str(d / "gray8.png"), g8.astype(np.float32)),
            "gray16": (str(d / "gray16.png"), g16.astype(np.float32)),
            "gray8_pil": (str(d / "gray8_pil.png"), g8.astype(np.float32)),
            "gray16_pil": (str(d / "gray16_pil.png"), g16.astype(np.float32)),
            "rgb": (str(d / "rgb.png"), gray.astype(np.float32))}


class TestNativeDecode:
    def test_library_builds(self):
        assert native_io.native_available(), native_io.build_error

    @pytest.mark.parametrize("name", ["gray8", "gray16", "gray8_pil", "gray16_pil"])
    def test_grey(self, png_files, name):
        path, want = png_files[name]
        np.testing.assert_array_equal(native_io.load_image(path), want)

    def test_writer_reads_back_in_pil(self, png_files):
        from PIL import Image

        for name in ("gray8", "gray16"):
            path, want = png_files[name]
            np.testing.assert_array_equal(np.asarray(Image.open(path), np.float32), want)

    def test_rgb_to_gray(self, png_files):
        path, want = png_files["rgb"]
        np.testing.assert_allclose(native_io.load_image(path), want, atol=0.51)

    def test_prefetcher(self, png_files):
        paths = [png_files["gray8"][0]] * 6 + [png_files["rgb"][0]] * 2
        loader = native_io.PrefetchingLoader(paths, n_workers=2, window=4)
        try:
            for i, p in enumerate(paths):
                np.testing.assert_array_equal(loader.get(i), native_io.load_image(p))
        finally:
            loader.close()

    def test_missing_file_raises(self):
        with pytest.raises(IOError):
            native_io.load_image("/nonexistent/file.png")
