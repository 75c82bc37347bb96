"""Observability: structured per-frame metrics + map snapshot rendering
(port of ``orbslam2_tpu.utils.telemetry``).

Replaces ORB-SLAM2's std::cout prints and Pangolin viewer: the tracker
emits one record a committed frame into a ``MetricsLog`` (JSONL, with stage
timers), and ``render_map_snapshot`` draws the map and trajectory top-down
to a PNG with matplotlib, imported only when called (a machine without it
raises its ImportError there), off the tracking path like ORB-SLAM2's
viewer thread.
"""

from __future__ import annotations

import json
import time
import traceback
from contextlib import contextmanager
from typing import Dict, List, Optional

import numpy as np


class MetricsLog:
    """Append-only JSONL metrics stream with stage timers."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._fh = open(path, "a") if path else None
        self.records: List[dict] = []
        self._timings: Dict[str, float] = {}

    @contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._timings[name] = self._timings.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def emit(self, **fields):
        rec = dict(fields)
        if self._timings:
            rec["t_ms"] = {k: round(v * 1000, 3) for k, v in self._timings.items()}
            self._timings = {}
        self.records.append(rec)
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def summary(self) -> dict:
        """Median/mean of numeric fields across records (the reference's
        end-of-run timing stats)."""
        out = {}
        keys = set()
        for r in self.records:
            keys |= {k for k, v in r.items() if isinstance(v, (int, float))}
        for k in keys:
            vals = [r[k] for r in self.records if isinstance(r.get(k), (int, float))]
            if vals:
                out[k] = {
                    "median": float(np.median(vals)),
                    "mean": float(np.mean(vals)),
                    "n": len(vals),
                }
        return out


class LiveViewer:
    """Background snapshot writer, the Pangolin viewer thread's analog.

    Renders the map + trajectory to `<out_dir>/map_XXXX.png` every
    `interval` seconds on a daemon thread, reading the host map without
    locks (the snapshot semantics of ORB-SLAM2's drawer copies).
    """

    def __init__(self, slam, out_dir: str, interval: float = 1.0):
        import os
        import threading

        self.slam = slam
        self.out_dir = out_dir
        self.interval = interval
        os.makedirs(out_dir, exist_ok=True)
        self._stop = threading.Event()
        self._n = 0
        self.error: Optional[str] = None  # the last snapshot's failure
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="live-viewer")
        self._thread.start()

    def _run(self):
        import os

        while not self._stop.wait(self.interval):
            try:
                traj = None
                if self.slam.tracker.trajectory:
                    traj = np.stack([
                        np.linalg.inv(T)[:3, 3]
                        for _, _, T in self.slam.tracker.trajectory
                    ])
                render_map_snapshot(
                    self.slam.map,
                    os.path.join(self.out_dir, f"map_{self._n:04d}.png"),
                    trajectory=traj,
                    title=f"t={self._n * self.interval:.0f}s",
                )
                self._n += 1
            except Exception:  # rendering must never take down the system
                self.error = traceback.format_exc()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5.0)


def render_map_snapshot(slam_map, path: str, trajectory=None, title=""):
    """Top-down (x-z) map points + keyframe positions + trajectory -> PNG.

    The FrameDrawer/MapDrawer replacement; requires matplotlib, not
    imported until called.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    m = slam_map
    fig, ax = plt.subplots(figsize=(8, 8))
    mps = m.valid_map_points()
    if len(mps):
        ax.scatter(m.mp_pos[mps, 0], m.mp_pos[mps, 2], s=1, c="#555555",
                   label=f"map points ({len(mps)})")
    kfs = m.valid_keyframes()
    if len(kfs):
        centers = np.stack([m.keyframe_center(int(k)) for k in kfs])
        ax.plot(centers[:, 0], centers[:, 2], "b.-", ms=4, lw=0.8,
                label=f"keyframes ({len(kfs)})")
    if trajectory is not None and len(trajectory):
        tr = np.asarray(trajectory)
        ax.plot(tr[:, 0], tr[:, 2], "g-", lw=0.6, alpha=0.7, label="trajectory")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal")
    ax.legend(loc="upper right", fontsize=8)
    if title:
        ax.set_title(title)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
