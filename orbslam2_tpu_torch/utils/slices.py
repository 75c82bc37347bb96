"""The configurations and rendered sequences the port is driven with on the
card, one per sensor (``chip_smoke.py``, ``utils/profile_slice.py``):

  rgbd       640x480, fx 520, bf 52, 1000 features, 8 levels (the
             reference's ``bench.py`` system configuration); frames and
             depth from ``render_sequence``.
  stereo     ``examples/settings/KITTI00-02.yaml``: 1241x376, fx 718.856,
             bf 386.1448, ThDepth 35, 2000 features, 8 levels, 10 fps; true
             left/right pairs of the box room, the right camera shifted by
             bf / fx along +x, along the orbit trajectory (drawn for 30
             frames/s) sampled at the settings' 10 frames/s: every third
             pose.
  monocular  ``examples/settings/TUM1.yaml``'s camera and extractor:
             640x480, fx 517.306, fy 516.469, 1000 features, 8 levels, with
             the distortion set to zero (the renderer draws a pinhole
             image).

The images are the renderer's float grey levels, as the reference's e2e
tests feed them (quantized to 8 bits, the same stereo sequence at 320x240
tracks with 3-4x the ATE in both packages).

``track(slam, sensor, frame, ts)`` feeds one frame to the entry point of
its sensor.

    python -m orbslam2_tpu_torch.utils.slices [--sensor stereo] [--frames 30]
        [--step 0] [--device cuda]

runs one sensor's sequence and prints, frame by frame, what the keyframe
decision reads (the pose's inliers against the points the reference
keyframe tracks, the close-point census), then the keyframes and the ATE;
``--step 1`` draws the stereo sequence at the orbit's 30 frames/s.
``tools/reference_slice_keyframes.py`` prints the same for the JAX package.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Tuple

import numpy as np

from ..config import CameraConfig, ExtractorConfig, SlamConfig, load_config
from .synthetic import make_box_room, orbit_trajectory, render, render_sequence

SENSORS = ("rgbd", "stereo", "monocular")
SETTINGS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "examples", "settings")
N_FRAMES = {"rgbd": 36, "stereo": 30, "monocular": 50}


def config(sensor: str) -> SlamConfig:
    if sensor == "rgbd":
        return SlamConfig(
            sensor="rgbd",
            camera=CameraConfig(fx=520.0, fy=520.0, cx=320.0, cy=240.0, width=640,
                                height=480, bf=52.0, fps=30),
            extractor=ExtractorConfig(n_features=1000, n_levels=8))
    if sensor == "stereo":
        return load_config(os.path.join(SETTINGS, "KITTI00-02.yaml"), sensor="stereo")
    if sensor == "monocular":
        cfg = load_config(os.path.join(SETTINGS, "TUM1.yaml"), sensor="monocular")
        for k in ("k1", "k2", "p1", "p2", "k3"):
            setattr(cfg.camera, k, 0.0)
        return cfg
    raise ValueError(f"unknown sensor {sensor!r}; one of {SENSORS}")


def intrinsics(cfg: SlamConfig) -> np.ndarray:
    c = cfg.camera
    return np.array([[c.fx, 0.0, c.cx], [0.0, c.fy, c.cy], [0.0, 0.0, 1.0]],
                    np.float32)


def frames(sensor: str, cfg: SlamConfig, n: int = 0,
           step: int = 0) -> Tuple[List, List[np.ndarray]]:
    """(frames, true Tcw poses) of ``n`` rendered frames (the sensor's
    default count with ``n`` = 0): (image, depth) for rgbd, (left, right)
    for stereo, the image for monocular. Stereo takes every ``step``-th
    pose of the 30 frames/s orbit (with 0, as the settings' fps asks)."""
    n = n or N_FRAMES[sensor]
    K = intrinsics(cfg)
    W, H = cfg.camera.width, cfg.camera.height
    if sensor == "rgbd":
        return render_sequence(n, K, width=W, height=H, with_depth=True)
    if sensor == "monocular":
        return render_sequence(n, K, width=W, height=H)
    planes = make_box_room(seed=0)
    step = step or max(int(round(30.0 / cfg.camera.fps)), 1)
    poses = orbit_trajectory(step * n)[::step]
    Trl = np.eye(4, dtype=np.float32)
    Trl[0, 3] = -cfg.camera.bf / cfg.camera.fx   # right cam: x_r = x_l - b
    pairs = [(render(planes, K, T, W, H), render(planes, K, Trl @ T, W, H))
             for T in poses]
    return pairs, poses


def track(slam, sensor: str, frame, ts: float):
    if sensor == "rgbd":
        return slam.track_rgbd(frame[0], frame[1], ts)
    if sensor == "stereo":
        return slam.track_stereo(frame[0], frame[1], ts)
    return slam.track_monocular(frame, ts)


def keyframe_line(i: int, pose, slam) -> str:
    tr, m = slam.tracker, slam.map
    ref = int((m.kf_mp[tr.ref_kf] >= 0).sum()) if tr.ref_kf >= 0 else 0
    return (f"frame {i}: tracked {int(pose is not None)}, inliers "
            f"{tr.n_inliers_last}, reference keyframe tracks {ref}, share "
            f"{tr.n_inliers_last / max(ref, 1):.3f}, close tracked "
            f"{tr.n_tracked_close} untracked {tr.n_untracked_close}, keyframes "
            f"{len(m.valid_keyframes())}")


def main():
    from ..system import SlamSystem
    from .evaluation import ate_rmse

    ap = argparse.ArgumentParser(description="One sensor's sequence, frame by "
                                 "frame: what the keyframe decision reads")
    ap.add_argument("--sensor", choices=SENSORS, default="stereo")
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--step", type=int, default=0,
                    help="stereo: every step-th pose of the 30 frames/s orbit "
                    "(0: the settings' fps)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cfg = config(args.sensor)
    seq, poses = frames(args.sensor, cfg, args.frames, args.step)
    slam = SlamSystem(cfg, device=args.device)
    est, gt = [], []
    for i, (frame, Tcw_true) in enumerate(zip(seq, poses)):
        pose = track(slam, args.sensor, frame, i / cfg.camera.fps)
        print(keyframe_line(i, pose, slam))
        if pose is not None:
            est.append(np.linalg.inv(pose)[:3, 3])
            gt.append(np.linalg.inv(Tcw_true)[:3, 3])
    kfs = slam.map.valid_keyframes()
    ate = ate_rmse(np.array(est), np.array(gt), with_scale=args.sensor == "monocular")
    print(f"port {args.sensor} {cfg.camera.width}x{cfg.camera.height}, step "
          f"{args.step}, {len(seq)} frames: {len(est)} tracked, {len(kfs)} "
          f"keyframes (frames {slam.map.kf_frame_id[kfs].tolist()}), ATE {ate:.5f} m")


if __name__ == "__main__":
    main()
