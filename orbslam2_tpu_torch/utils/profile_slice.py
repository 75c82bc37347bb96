"""Where the time goes in a slice on one GPU.

    python -m orbslam2_tpu_torch.utils.profile_slice [--sensor rgbd]
        [--frames 36] [--reps 2]

Runs ``SlamSystem`` in the sensor's configuration of ``utils/slices.py``
(rgbd: 640x480, 1000 features, 8 levels; stereo: KITTI 1241x376, 2000
features; monocular: TUM 640x480, 1000 features: the configurations
``chip_smoke.py`` drives) over its rendered frames in one process, ``--reps`` reps and then two profiled ones, each rep on a new
system. Every rep prints its frames/s. The first ``--reps`` print host-clock
time per stage: the tracker and local-mapper methods are wrapped so that
each call ends in ``torch.cuda.synchronize()``, which serialises host and
device and so slows the run it measures. The two profiled reps run
``torch.profiler`` over frames 12-23. The first of them keeps the stage wrappers and marks each call with
``torch.profiler.record_function``; since each call ends in a synchronise,
the device events inside a call's window are that stage's work, and each
stage's wall time splits into device busy time and the rest, the time the
device waits on the host. The last rep has no stage wrappers; it prints the
device's busy share (the time of CUDA kernel, memset and memcpy events
only, over the window's wall time, which the profiler's own host overhead
lengthens), the device events per frame, and the kernels with the most
device time. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import bisect
import subprocess
import time

import torch

from ..system import SlamSystem
from . import slices

WINDOW = (12, 24)   # profiled frames [first, last)

TRACKER_STAGES = {"_make_frame": "extract+upload", "_dispatch_track": "cascade",
                  "_create_keyframe": "create_kf",
                  "_initialize_monocular": "mono_init",
                  "_track_reference_keyframe": "ref_kf_fallback"}
MAPPER_STAGES = ("_create_new_points", "_fuse_neighbors",
                 "local_bundle_adjustment", "_flush_attrs_pending",
                 "_cull_keyframes", "_refresh_tracked_points",
                 "_cull_map_points")


def _timed(obj, name, key, acc, mark=False):
    """Wrap ``obj.name`` so that each call ends in a synchronise and adds its
    host-clock time to ``acc[key]``; with ``mark``, inside a profiler range
    named "stage:<key>"."""
    fn = getattr(obj, name)

    def wrapper(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        if mark:
            with torch.profiler.record_function("stage:" + key):
                out = fn(*a, **k)
                torch.cuda.synchronize()
        else:
            out = fn(*a, **k)
            torch.cuda.synchronize()
        acc[key] = acc.get(key, 0.0) + time.perf_counter() - t
        return out

    setattr(obj, name, wrapper)


def _is_device(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CUDA


def stage_split(prof) -> dict:
    """{stage: (calls, wall ms, device busy ms)} from the "stage:" ranges
    of a profile and the device events that overlap them."""
    windows, busy = {}, []
    for e in prof.events():
        if e.name.startswith("stage:"):
            if not _is_device(e):   # the range's device-side copy is no work
                windows.setdefault(e.name[6:], []).append(
                    (e.time_range.start, e.time_range.end))
        elif _is_device(e):
            busy.append((e.time_range.start, e.time_range.end))
    busy.sort()
    starts = [b[0] for b in busy]
    out = {}
    for key, ws in windows.items():
        wall = dev = 0.0
        for a, b in ws:
            wall += b - a
            for d0, d1 in busy[:bisect.bisect_left(starts, b)]:
                if d1 > a:
                    dev += min(d1, b) - max(d0, a)
        out[key] = (len(ws), wall / 1e3, dev / 1e3)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sensor", choices=slices.SENSORS, default="rgbd")
    ap.add_argument("--frames", type=int, default=0,
                    help="frames (default: the sensor's count in utils/slices.py)")
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; sensor {args.sensor}")
    cfg = slices.config(args.sensor)
    frames, _ = slices.frames(args.sensor, cfg, args.frames)
    dev = torch.device("cuda")
    split = None
    for rep in range(args.reps + 2):
        profiled = rep >= args.reps
        last = rep == args.reps + 1
        slam = SlamSystem(cfg, device=dev)
        acc = {}
        if not last:
            for name, key in TRACKER_STAGES.items():
                _timed(slam.tracker, name, key, acc, mark=profiled)
            for name in MAPPER_STAGES:
                _timed(slam.local_mapper, name, "map:" + name, acc, mark=profiled)
            _timed(slam.local_mapper, "process_keyframe", "mapping_total", acc,
                   mark=profiled)
        prof = None
        times = []
        for i, frame in enumerate(frames):
            if profiled and i == WINDOW[0]:
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
                t_win = time.perf_counter()
            t1 = time.perf_counter()
            slices.track(slam, args.sensor, frame, i / 30.0)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
            if prof is not None and i == WINDOW[1] - 1:
                wall = time.perf_counter() - t_win
                prof.__exit__(None, None, None)
        total = sum(times)
        kind = (" (profiled, no stage timers)" if last else
                " (profiled, stage split)" if profiled else "")
        print(f"rep {rep}{kind}: {len(times)} frames {total:.3f} s = "
              f"{len(times) / total:.2f} frames/s; "
              f"{len(slam.map.valid_keyframes())} keyframes")
        if profiled and not last:
            split = stage_split(prof)
            continue
        for key, v in sorted(acc.items(), key=lambda kv: -kv[1]):
            print(f"  {key:34s} {v * 1e3:9.1f} ms ({100 * v / total:5.1f}%)")
    print(f"stage split over frames {WINDOW[0]}-{WINDOW[1] - 1} (profiled, each "
          f"call synchronised): calls, wall ms, device busy ms, host ms "
          f"(wall - busy)")
    for key, (n, wall, busy) in sorted(split.items(), key=lambda kv: -kv[1][1]):
        print(f"  {key:34s} {n:4d} {wall:9.2f} {busy:9.2f} {wall - busy:9.2f}")
    # device events only: an aten op's device time repeats its kernels'
    dev_events = [e for e in prof.key_averages() if _is_device(e)]
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
