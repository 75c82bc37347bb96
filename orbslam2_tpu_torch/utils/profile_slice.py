"""Where the time goes in a slice on one GPU.

    python -m orbslam2_tpu_torch.utils.profile_slice [--sensor rgbd]
        [--frames 36] [--reps 2] [--reloc | --loop]

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

``--reloc`` (RGB-D) maps the frames once, then each rep feeds 3 blank
frames (LOST) and the revisited views 10-19 until the tracker
relocalizes, with the relocalization's stages timed (BoW query on kernel
Y, database, kernel U, kernel Z, the projection passes); a last rep is
profiled and split into device busy and host time as above.

``--loop`` runs the loop circuit (``utils/slices.circuit``: 240 RGB-D
frames at 320x240, loop closing on) ``--reps`` times, each on a new system,
and times the stages of the loop closure (detection, kernel U, K, M's search
and LM, the acceptance count on C, the group correction, the fuse on T, the
essential graph on P, GBA's gather, solve and write-back), each call
synchronised; a last rep profiles the closing keyframe's loop closure alone
and splits each stage into device busy and host time.
"""

from __future__ import annotations

import argparse
import bisect
import subprocess
import time

import numpy as np
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


def _stage_timer(acc, state):
    """A function wrap(obj, name, key) that replaces ``obj.name`` by a
    synchronised call adding its host-clock time to ``acc[key]``, inside a
    profiler range "stage:<key>" while ``state["mark"]``; returns the
    original."""
    def wrap(obj, name, key):
        fn = getattr(obj, name)

        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            if state["mark"]:
                with torch.profiler.record_function("stage:" + key):
                    out = fn(*a, **k)
                    torch.cuda.synchronize()
            else:
                out = fn(*a, **k)
                torch.cuda.synchronize()
            acc[key] = acc.get(key, 0.0) + time.perf_counter() - t
            return out

        setattr(obj, name, wrapper)
        return fn

    return wrap


RELOC_STAGES = (("kfdb", "compute_bow", "bow"),
                ("kfdb", "detect_relocalization_candidates", "database"),
                ("tracker", "_project_pass", "passes"),
                ("tracker", "_relocalize", "relocalize"))


def reloc_profile(cfg, frames, dev, reps: int):
    """The --reloc run: see the module's docstring."""
    from ..kernels import match_rot, pnp_ransac

    slam = SlamSystem(cfg, device=dev)
    for i, frame in enumerate(frames):
        slices.track(slam, "rgbd", frame, i / 30.0)
    print(f"mapped {len(frames)} frames: {len(slam.map.valid_keyframes())} "
          f"keyframes, {int(slam.kfdb.in_db.sum())} in the database")
    acc, state = {}, {"mark": False}
    wrap = _stage_timer(acc, state)
    for owner, name, key in RELOC_STAGES:
        wrap(getattr(slam, owner), name, key)
    wrap(match_rot, "match_rot", "U")
    wrap(pnp_ransac, "pnp_ransac", "Z")
    h, w = frames[0][0].shape
    blank = np.zeros((h, w), np.float32)
    ts = 1000.0
    split = None
    for rep in range(reps + 1):
        profiled = rep == reps
        for _ in range(3):
            slices.track(slam, "rgbd", (blank, blank), ts)
            ts += 1.0
        acc.clear()
        state["mark"] = profiled
        prof = None
        if profiled:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        t1 = time.perf_counter()
        for n, i in enumerate(range(10, 20), 1):
            pose = slices.track(slam, "rgbd", frames[i], ts)
            ts += 1.0
            torch.cuda.synchronize()
            if pose is not None:
                break
        wall = time.perf_counter() - t1
        if prof is not None:
            prof.__exit__(None, None, None)
            split = stage_split(prof)
        print(f"rep {rep}{' (profiled)' if profiled else ''}: relocalized "
              f"{pose is not None} after {n} frames, {wall * 1e3:.2f} ms "
              f"(reference keyframe {slam.tracker.ref_kf})")
        for key, v in sorted(acc.items(), key=lambda kv: -kv[1]):
            print(f"  {key:12s} {v * 1e3:9.2f} ms")
    print("stage split of the profiled rep: calls, wall ms, device busy ms, "
          "host ms (wall - busy)")
    for key, (n, wall, busy) in sorted(split.items(), key=lambda kv: -kv[1][1]):
        print(f"  {key:12s} {n:4d} {wall:9.2f} {busy:9.2f} {wall - busy:9.2f}")


LOOP_STAGES = (("closer", "_detect_loop", "detect"),
               ("closer", "_match_map_points", "U"),
               ("sim3_ransac", "sim3_ransac", "K"),
               ("sim3_search", "search_by_sim3", "M_search"),
               ("sim3_opt", "optimize_sim3", "M_opt"),
               ("closer", "_count_projected_matches", "C_count"),
               ("closer", "_correct_group", "correct"),
               ("closer", "_search_and_fuse", "fuse"),
               ("closer", "_optimize_essential_graph", "essential"),
               ("closer", "_gba_gather", "gba_gather"),
               ("closer", "_gba_solve", "gba"),
               ("closer", "_gba_write_back", "write_back"))


def loop_profile(dev, reps: int):
    """The --loop run: see the module's docstring."""
    from ..kernels import sim3_opt, sim3_ransac, sim3_search

    frames, poses = slices.circuit()
    cfg = slices.config("circuit")
    split = None
    for rep in range(reps + 1):
        profiled = rep == reps
        slam = SlamSystem(cfg, device=dev)
        closer = slam.loop_closer
        owners = dict(closer=closer, sim3_ransac=sim3_ransac,
                      sim3_search=sim3_search, sim3_opt=sim3_opt)
        acc, state, out = {}, {"mark": False}, {}
        wrap = _stage_timer(acc, state)
        restore = [(owners[o], n, wrap(owners[o], n, key))
                   for o, n, key in LOOP_STAGES]
        process = closer.process_keyframe

        def timed_process(kf, *a, **k):
            acc.clear()
            prof = None
            if profiled and not out:  # profile each keyframe until one closes
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
                state["mark"] = True
            torch.cuda.synchronize()
            t = time.perf_counter()
            closed = process(kf, *a, **k)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            if prof is not None:
                state["mark"] = False
                prof.__exit__(None, None, None)
            if closed and not out:
                out.update(stages=dict(acc), wall=wall, kf=kf,
                           stats=dict(closer.last_stats),
                           split=stage_split(prof) if prof is not None else None)
            return closed

        closer.process_keyframe = timed_process
        t0 = time.perf_counter()
        for i, frame in enumerate(frames):
            slices.track(slam, "rgbd", frame, i / 30.0)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        for obj, name, fn in restore:
            setattr(obj, name, fn)
        post = slices.keyframe_ate(slam, poses)
        print(f"rep {rep}{' (profiled closure)' if profiled else ''}: "
              f"{len(frames)} frames {total:.3f} s = {len(frames) / total:.2f} "
              f"frames/s; {closer.loops_closed} loops, "
              f"{len(slam.map.valid_keyframes())} keyframes, keyframe ATE "
              f"{post:.5f} m")
        if not out:
            print("  no loop closed")
            continue
        print(f"  closure at keyframe {out['kf']}: {out['wall'] * 1e3:.2f} ms "
              f"({out['stats']})")
        for key, v in sorted(out["stages"].items(), key=lambda kv: -kv[1]):
            print(f"  {key:12s} {v * 1e3:9.2f} ms")
        split = out["split"] or split
    if split:
        print("stage split of the profiled closure: calls, wall ms, device busy "
              "ms, host ms (wall - busy)")
        for key, (n, wall, busy) in sorted(split.items(), key=lambda kv: -kv[1][1]):
            print(f"  {key:12s} {n:4d} {wall:9.2f} {busy:9.2f} {wall - busy:9.2f}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sensor", choices=slices.SENSORS, default="rgbd")
    ap.add_argument("--frames", type=int, default=0,
                    help="frames (default: the sensor's count in utils/slices.py)")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--reloc", action="store_true",
                    help="time relocalization on the mapped RGB-D frames")
    ap.add_argument("--loop", action="store_true",
                    help="time one loop closure on the loop circuit")
    args = ap.parse_args()
    if args.reloc and args.sensor != "rgbd":
        raise SystemExit("profile_slice: --reloc runs on the rgbd sensor")
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; sensor {args.sensor}")
    dev = torch.device("cuda")
    if args.loop:
        loop_profile(dev, args.reps)
        return
    cfg = slices.config(args.sensor)
    frames, _ = slices.frames(args.sensor, cfg, args.frames)
    if args.reloc:
        reloc_profile(cfg, frames, dev, args.reps)
        return
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
