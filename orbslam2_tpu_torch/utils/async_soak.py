"""Soak run of the asynchronous system, to catch its rare faults: the loop
circuit (``slices.circuit``, 240 RGB-D frames at 320x240) through
``AsyncSlamSystem`` with background global BA, fed with the reference async
test's back-pressure (wait while 3 keyframes are queued), many times. Each
run is held to that test's bounds (a loop closes, finite keyframe poses,
keyframe ATE < 0.2 m), and each loop closure is recorded: the frames of
its two keyframes, the Sim3's scale, translation and rotation, and the
keyframe ATE before the correction, after the essential graph and after
each global-BA write-back. While it runs, every writer of keyframe poses (the
tracker's keyframe insertion, local BA's write-back, the loop correction,
its fuse, the essential graph, global BA's write-back) is checked for a
pose that is not finite or has an entry past 1e3, and names itself when it
leaves one. With ``--poison``, before every second run the card's and the
pinned host memory's allocator caches are filled with freed NaN blocks, so
that a kernel or a copy that reads memory nothing wrote leaves a NaN.

    python -m orbslam2_tpu_torch.utils.async_soak --runs 30 [--poison]
        [--device cuda]

Prints a JSON line a run and a summary line; exits 1 if a run failed.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import sys
import threading
import time

import numpy as np
import torch

LOOP_ATE = 0.2  # m, tests/test_loop_e2e.py's async bound
FAR = 1e3       # a keyframe pose entry past this is reported


def bad_keyframes(m) -> set:
    """Live keyframes whose pose is not finite or has an entry past FAR
    (read from copies: another thread may be writing)."""
    n = m.n_kf
    valid = m.kf_valid[:n].copy()
    P = m.kf_pose[:n].copy()
    ok = np.isfinite(P).all(axis=(1, 2)) & (np.abs(P) < FAR).all(axis=(1, 2))
    return set(np.flatnonzero(valid & ~ok).tolist())


@contextlib.contextmanager
def watch_writers(events: list):
    """Within ``with``, each keyframe-pose writer appends (writer, thread,
    keyframes) to ``events`` when it leaves a keyframe bad_keyframes did
    not list before it ran."""
    from ..local_mapping import LocalMapper
    from ..loop_closing import LoopCloser
    from ..map.state import MapState

    writers = [(LocalMapper, "_local_ba_write_back", lambda s: s.map),
               (MapState, "add_keyframe", lambda s: s)]
    writers += [(LoopCloser, name, lambda s: s.map) for name in (
        "_correct_group", "_search_and_fuse", "_optimize_essential_graph",
        "_gba_write_back")]
    saved = []
    for cls, name, get_map in writers:
        fn = getattr(cls, name)
        saved.append((cls, name, fn))

        def watched(self, *a, _fn=fn, _get=get_map, _name=f"{cls.__name__}.{name}", **k):
            before = bad_keyframes(_get(self))
            out = _fn(self, *a, **k)
            new = bad_keyframes(_get(self)) - before
            if new:
                events.append((_name, threading.current_thread().name, sorted(new)))
            return out

        setattr(cls, name, functools.wraps(fn)(watched))
    try:
        yield
    finally:
        for cls, name, fn in saved:
            setattr(cls, name, fn)


class _MapTrajectory:
    """The keyframe trajectory of a map, as slices.keyframe_ate reads it."""

    def __init__(self, m):
        self.map = m

    def keyframe_trajectory(self):
        m = self.map
        return [(float(m.kf_timestamp[k]), m.kf_pose[k].copy())
                for k in m.valid_keyframes()]


@contextlib.contextmanager
def watch_closures(closures: list, gbas: list, poses):
    """Within ``with``, each loop correction appends its record to
    ``closures`` and each global-BA write-back the keyframe ATE after it to
    ``gbas`` (both run under the map lock, so the map is still)."""
    from ..loop_closing import LoopCloser
    from ..ops import sim3_np
    from . import slices

    correct, write_back = LoopCloser._correct_loop, LoopCloser._gba_write_back

    def ate(m):
        a = slices.keyframe_ate(_MapTrajectory(m), poses)
        return None if a is None else float(a)

    def correct_loop(self, kf, loop_kf, S12, *a, **k):
        m = self.map
        S12 = np.asarray(S12, np.float32)
        R = sim3_np.to_se3(S12[None])[0][:3, :3]
        rec = dict(frame=int(m.kf_frame_id[kf]), loop_frame=int(m.kf_frame_id[loop_kf]),
                   scale=float(S12[0]), t=float(np.linalg.norm(S12[5:8])),
                   rot_deg=float(np.degrees(np.arccos(np.clip(
                       (np.trace(R) - 1) / 2, -1, 1)))),
                   ate_before=ate(m))
        out = correct(self, kf, loop_kf, S12, *a, **k)
        rec["ate_after"] = ate(m)
        closures.append(rec)
        return out

    def gba_write_back(self, *a, **k):
        out = write_back(self, *a, **k)
        gbas.append(ate(self.map))
        return out

    LoopCloser._correct_loop = correct_loop
    LoopCloser._gba_write_back = gba_write_back
    try:
        yield
    finally:
        LoopCloser._correct_loop, LoopCloser._gba_write_back = correct, write_back


def poison(device):
    """Fill the allocator caches with freed NaN blocks: device blocks from
    512 bytes to 64 MiB, pinned host blocks from 64 bytes to 1 MiB."""
    keep = [torch.full((nbytes // 4,), float("nan"), device=device)
            for nbytes, n in ((512, 4000), (4096, 2000), (1 << 16, 600),
                              (1 << 20, 200), (1 << 22, 60), (1 << 24, 20),
                              (1 << 26, 6)) for _ in range(n)]
    for nbytes, n in ((64, 200), (1024, 200), (1 << 16, 100), (1 << 20, 20)):
        for _ in range(n):
            keep.append(torch.empty(nbytes // 4, pin_memory=True).fill_(float("nan")))
    torch.cuda.synchronize(device)
    del keep


def circuit_run(frames, poses, device) -> dict:
    """One run of the circuit through AsyncSlamSystem; its readings."""
    from ..pipeline import AsyncSlamSystem
    from . import slices

    slam = AsyncSlamSystem(slices.config("circuit"), device=device)
    t0 = time.perf_counter()
    for i, (img, depth) in enumerate(frames):
        slam.track_rgbd(img, depth, i / 30.0)
        waited = 0.0
        while slam._kf_queue.qsize() >= 3 and waited < 5.0:
            time.sleep(0.01)
            waited += 0.01
    slam.shutdown()
    m = slam.map
    kfs = m.valid_keyframes()
    finite = bool(np.isfinite(m.kf_pose[kfs]).all())
    ate = slices.keyframe_ate(slam, poses) if finite else None
    loops = slam.loop_closer.loops_closed
    return dict(seconds=time.perf_counter() - t0, loops=loops, keyframes=len(kfs),
                finite=finite, keyframe_ate=ate,
                ok=loops >= 1 and finite and ate is not None and ate < LOOP_ATE)


def main(argv=None) -> int:
    from ..kernels import build
    from . import slices

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--poison", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        build.library()
    frames, poses = slices.circuit()
    failed = []
    for run in range(args.runs):
        poisoned = args.poison and device.type == "cuda" and run % 2 == 1
        if poisoned:
            poison(device)
        events, closures, gbas = [], [], []
        with watch_writers(events), watch_closures(closures, gbas, poses):
            try:
                res = circuit_run(frames, poses, device)
            except Exception as e:  # a run's failure is a reading
                res = dict(ok=False, error=repr(e))
        res.update(run=run, poisoned=poisoned, bad_writers=events,
                   closures=closures, gba_ate=gbas)
        print(json.dumps(res), flush=True)
        if not res["ok"]:
            failed.append(run)
    print(json.dumps(dict(runs=args.runs, failed=failed)), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
