"""Dataset runner: the ORB-SLAM2 example binaries in one entry point.

    python -m orbslam2_tpu_torch.examples.run_slam MODE SETTINGS SEQUENCE

MODE is one of tum-mono, tum-rgbd, kitti-mono, kitti-stereo, euroc-mono and
euroc-stereo; SETTINGS an ORB-SLAM2 settings YAML as it is (for example
``examples/settings/TUM1.yaml``); SEQUENCE the dataset directory. Writes
CameraTrajectory.txt and KeyFrameTrajectory.txt (TUM format; the camera
trajectory in KITTI format for kitti-*) and prints the median and mean
tracking time, as the ORB-SLAM2 mains do.

Runs on the card (``--device cuda``, the default; without one it fails)
unless ``--device cpu`` is given. ``--async-mapping`` runs mapping and loop
closing on worker threads with pipelined tracking; ``--warmup`` builds the
kernels and runs a scratch frame first; ``--viewer-port`` serves the live
map page; ``--save-map`` writes the map at the end.
"""

import argparse
import time

import numpy as np

from ..config import load_config
from ..device import DEFAULT as DEFAULT_DEVICE
from ..system import SlamSystem
from ..utils import datasets

MODES = ("tum-mono", "tum-rgbd", "kitti-mono", "kitti-stereo", "euroc-mono",
         "euroc-stereo")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=MODES)
    ap.add_argument("settings")
    ap.add_argument("sequence")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--traj-out", default="CameraTrajectory.txt")
    ap.add_argument("--kf-traj-out", default="KeyFrameTrajectory.txt")
    ap.add_argument("--save-map", default="")
    ap.add_argument("--viewer-port", type=int, default=-1,
                    help="serve the interactive live map at this port "
                         "(0 = ephemeral; default off)")
    ap.add_argument("--async-mapping", action="store_true",
                    help="run mapping + loop closing on background workers "
                         "with pipelined tracking (tracking returns poses "
                         "a frame or two late)")
    ap.add_argument("--warmup", action="store_true",
                    help="build the kernels and run a scratch frame and "
                         "keyframe round before the frame loop")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="torch device (default: the card; 'cpu' to run "
                         "on the CPU)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    sensor = {"mono": "monocular", "rgbd": "rgbd", "stereo": "stereo"}[
        args.mode.split("-")[1]]
    cfg = load_config(args.settings, sensor=sensor)
    if args.async_mapping:
        from ..pipeline import AsyncSlamSystem

        slam = AsyncSlamSystem(cfg, device=args.device)
    else:
        slam = SlamSystem(cfg, device=args.device)
    if args.warmup:
        print(f"warmup: {slam.warmup():.1f}s")
    viewer = None
    if args.viewer_port >= 0:
        from ..utils.http_viewer import HttpViewer

        viewer = HttpViewer(slam, port=args.viewer_port)
        print(f"live viewer: http://127.0.0.1:{viewer.port}/")

    times = []
    try:
        run_frames(args.mode, args.sequence, cfg, slam, times, args.max_frames)
    finally:
        if viewer is not None:
            viewer.stop()
        slam.shutdown()
    n = len(times)
    print(f"frames: {n}")
    if n:
        print(f"median tracking time: {sorted(times)[n // 2] * 1000:.2f} ms")
        print(f"mean tracking time:   {np.mean(times) * 1000:.2f} ms")
    if args.mode.startswith("kitti"):
        slam.save_trajectory_kitti(args.traj_out)
    else:
        slam.save_trajectory_tum(args.traj_out)
    slam.save_keyframe_trajectory_tum(args.kf_traj_out)
    if args.save_map:
        slam.save_map(args.save_map)
        print(f"map saved to {args.save_map}")


def frames_of(mode: str, sequence: str, cfg, rectifier=None):
    """(track method name, its image arguments, timestamp) of each frame of
    the sequence in ``mode``; EuRoC stereo frames are rectified by
    ``rectifier``, by default with the settings' LEFT./RIGHT. blocks where
    the file has them. A EuRoC stereo frame without a right image is
    skipped, as the reference's evaluation harness skips it (a named
    divergence from the reference runner, which hands it to
    ``track_monocular`` and fails on the stereo system)."""
    if mode == "tum-rgbd":
        for ts, img, depth in datasets.tum_rgbd_sequence(
                sequence, cfg.camera.depth_map_factor or 5000.0):
            yield "track_rgbd", (img, depth), ts
    elif mode == "tum-mono":
        for ts, img in datasets.tum_mono_sequence(sequence):
            yield "track_monocular", (img,), ts
    elif mode.startswith("kitti"):
        stereo = mode.endswith("stereo")
        for ts, left, right in datasets.kitti_sequence(sequence, stereo):
            yield (("track_stereo", (left, right), ts) if stereo
                   else ("track_monocular", (left,), ts))
    else:
        stereo = mode.endswith("stereo")
        if stereo and rectifier is None and cfg.stereo_rectify is not None:
            from ..utils.rectify import YamlRectifier

            rectifier = YamlRectifier(cfg.stereo_rectify)
        for ts, left, right in datasets.euroc_sequence(sequence, stereo):
            if not stereo:
                yield "track_monocular", (left,), ts
            elif right is not None:
                if rectifier is not None:
                    left, right = rectifier(left, right)
                yield "track_stereo", (left, right), ts


def run_frames(mode: str, sequence: str, cfg, slam, times, max_frames: int = 0,
               rectifier=None):
    """Track the sequence's frames (the first ``max_frames`` with a limit),
    appending each call's seconds to ``times``."""
    for method, imgs, ts in frames_of(mode, sequence, cfg, rectifier):
        t0 = time.perf_counter()
        getattr(slam, method)(*imgs, ts)
        times.append(time.perf_counter() - t0)
        if max_frames and len(times) >= max_frames:
            break


if __name__ == "__main__":
    main()
