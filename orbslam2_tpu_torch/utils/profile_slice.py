"""Where the time goes in the RGB-D slice on one GPU.

    python -m orbslam2_tpu_torch.utils.profile_slice [--frames 36] [--reps 3]

Runs ``SlamSystem`` (RGB-D, 640x480, 1000 features, 8 levels: the
configuration ``chip_smoke.py`` drives) over rendered frames ``--reps``
times in one process, each rep on a new system. Every rep prints its
frames/s. All reps but the last also print host-clock time per stage: the
tracker and local-mapper methods are wrapped so that each call ends in
``torch.cuda.synchronize()``, which serialises host and device and so slows
the run it measures. The last rep has no stage timers; it runs
``torch.profiler`` over frames 12-23 and prints the device's busy share
(the time of CUDA kernel and memcpy events only, over the window's wall
time, which the profiler's own host overhead lengthens), the device events
per frame, and the kernels with the most device time. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from ..config import CameraConfig, ExtractorConfig, SlamConfig
from ..system import SlamSystem
from .synthetic import render_sequence

W, H, FX = 640, 480, 520.0
WINDOW = (12, 24)   # profiled frames [first, last)

TRACKER_STAGES = {"_make_frame": "extract+upload", "_dispatch_track": "cascade",
                  "_create_keyframe": "create_kf"}
MAPPER_STAGES = ("_create_new_points", "_fuse_neighbors",
                 "local_bundle_adjustment", "_flush_attrs_pending",
                 "_cull_keyframes", "_refresh_tracked_points",
                 "_cull_map_points")


def _timed(obj, name, key, acc):
    fn = getattr(obj, name)

    def wrapper(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        acc[key] = acc.get(key, 0.0) + time.perf_counter() - t
        return out

    setattr(obj, name, wrapper)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=36)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1]], np.float32)
    frames, _ = render_sequence(args.frames, K, width=W, height=H,
                                with_depth=True)
    cfg = SlamConfig(
        sensor="rgbd",
        camera=CameraConfig(fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W,
                            height=H, bf=52.0, fps=30),
        extractor=ExtractorConfig(n_features=1000, n_levels=8))
    dev = torch.device("cuda")
    for rep in range(args.reps):
        last = rep == args.reps - 1
        slam = SlamSystem(cfg, device=dev)
        acc = {}
        if not last:
            for name, key in TRACKER_STAGES.items():
                _timed(slam.tracker, name, key, acc)
            for name in MAPPER_STAGES:
                _timed(slam.local_mapper, name, "map:" + name, acc)
            _timed(slam.local_mapper, "process_keyframe", "mapping_total", acc)
        prof = None
        times = []
        for i, (img, depth) in enumerate(frames):
            if last and i == WINDOW[0]:
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
                t_win = time.perf_counter()
            t1 = time.perf_counter()
            slam.track_rgbd(img, depth, i / 30.0)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
            if prof is not None and i == WINDOW[1] - 1:
                wall = time.perf_counter() - t_win
                prof.__exit__(None, None, None)
        total = sum(times)
        print(f"rep {rep}{' (profiled, no stage timers)' if last else ''}: "
              f"{len(times)} frames {total:.3f} s = {len(times) / total:.2f} "
              f"frames/s; {len(slam.map.valid_keyframes())} keyframes")
        for key, v in sorted(acc.items(), key=lambda kv: -kv[1]):
            print(f"  {key:34s} {v * 1e3:9.1f} ms ({100 * v / total:5.1f}%)")
    if prof is None:
        return
    # device events only: an aten op's device time repeats its kernels'
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev_events) / 1e3
    n_frames = WINDOW[1] - WINDOW[0]
    n_launch = sum(e.count for e in dev_events)
    print(f"profiled frames {WINDOW[0]}-{WINDOW[1] - 1}: wall {wall * 1e3:.1f} ms, "
          f"device busy {busy:.1f} ms = {100 * busy / (wall * 1e3):.1f}%, "
          f"{n_launch / n_frames:.0f} device events per frame")
    for e in sorted(dev_events, key=lambda e: -e.self_device_time_total)[:20]:
        print(f"  {e.self_device_time_total / 1e3:8.2f} ms  n={e.count:6d}  "
              f"{e.key[:90]}")


if __name__ == "__main__":
    main()
