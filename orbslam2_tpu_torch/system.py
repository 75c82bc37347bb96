"""SlamSystem facade — the public API (port of ``orbslam2_tpu.system``;
``pipeline.AsyncSlamSystem`` runs it with mapping and loop closing on
worker threads).

Construction wires the map, the keyframe database, the tracker, the
local mapper and (by default, as the reference) the loop closer onto one
``device``; ``track_rgbd``, ``track_stereo`` and ``track_monocular`` track a
frame, then run local mapping on every keyframe it created, in order, and
the synchronous loop closer on each keyframe still valid: detection, the
Sim3 alignment, the correction, the essential graph and global BA, after
which the keyframe enters the database. A lost tracker relocalizes against
the database. ``save_map`` / ``load_map`` persist the map and the database
(the reference's file format); localization mode tracks without growing
the map. Trajectories export in the TUM and KITTI formats. With loop
closing on, the mapper launches each keyframe's BoW vector at the start of
its round (``KeyFrameDatabase.precompute_async``). ``warmup()`` builds the
kernel library and runs a synthetic frame and keyframe round beforehand.
``metrics_path`` streams one JSON record a committed frame
(``utils/telemetry.MetricsLog``); ``render_snapshot`` draws the map and
trajectory to a PNG (matplotlib).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .config import SlamConfig
from .device import DEFAULT as DEFAULT_DEVICE, resolve as resolve_device
from .local_mapping import LocalMapper
from .loop_closing import LoopCloser
from .map.keyframe_database import KeyFrameDatabase
from .map.state import MapState
from .ops import geometry as geo
from .tracking import Tracker, TrackingState


class SlamSystem:
    def __init__(self, cfg: SlamConfig, enable_loop_closing: bool = True,
                 device=DEFAULT_DEVICE, metrics_path: Optional[str] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.enable_loop_closing = enable_loop_closing
        self.localization_only = False
        self.metrics_log = None
        if metrics_path:
            from .utils.telemetry import MetricsLog

            self.metrics_log = MetricsLog(metrics_path)
        self._build()

    def _build(self):
        self.map = MapState.allocate(self.cfg, device=self.device)
        self.kfdb = KeyFrameDatabase(self.map, device=self.device)
        self.tracker = Tracker(self.cfg, self.map, kfdb=self.kfdb,
                               device=self.device)
        self.tracker.localization_only = self.localization_only
        self.tracker.metrics_log = self.metrics_log
        self.local_mapper = LocalMapper(self.cfg, self.map, self.tracker.cam)
        self.loop_closer = LoopCloser(
            self.cfg, self.map, self.tracker.cam, self.kfdb
        ) if self.enable_loop_closing else None
        if self.loop_closer is not None:  # else nothing takes the vectors
            self.local_mapper.bow_precompute = self.kfdb.precompute_async

    def warmup(self) -> float:
        """Build the kernel library and run one synthetic frame and one
        keyframe round at this system's shapes on a scratch map, so that
        the first real frame pays no build or module load; returns the
        seconds taken."""
        from .warmup import warmup_system

        return warmup_system(self)

    def render_snapshot(self, path: str, title: str = ""):
        """Export a top-down map/trajectory PNG (the viewer replacement;
        needs matplotlib)."""
        from .utils.telemetry import render_map_snapshot

        traj = np.stack(
            [np.linalg.inv(T)[:3, 3] for _, _, T in self.tracker.trajectory]
        ) if self.tracker.trajectory else None
        render_map_snapshot(self.map, path, trajectory=traj, title=title)

    # ------------------------------------------------------------------
    # Tracking entry points
    # ------------------------------------------------------------------
    def track_monocular(self, img: np.ndarray, timestamp: float) -> Optional[np.ndarray]:
        assert self.cfg.sensor == "monocular"
        return self._track(img, timestamp, None)

    def track_rgbd(self, img: np.ndarray, depth: np.ndarray,
                   timestamp: float) -> Optional[np.ndarray]:
        assert self.cfg.sensor == "rgbd"
        return self._track(img, timestamp, depth)

    def track_stereo(self, left: np.ndarray, right: np.ndarray,
                     timestamp: float) -> Optional[np.ndarray]:
        assert self.cfg.sensor == "stereo"
        return self._track(left, timestamp, None, right_img=right)

    def _track(self, img, timestamp, depth, right_img=None):
        pose = self.tracker.track(img, timestamp, depth_map=depth,
                                  right_img=right_img)
        if self.tracker.reset_requested:
            # lost within ~5 keyframes of init: the bootstrap map is junk
            self.reset()
            return pose
        for kf in self._drain_keyframes():
            self.local_mapper.process_keyframe(kf)
            if self.loop_closer is not None and self.map.kf_valid[kf]:
                self.loop_closer.process_keyframe(kf)
        return pose

    def _drain_keyframes(self):
        kfs = self.tracker.pending_keyframes
        if kfs and not self.localization_only:
            self.tracker.pending_keyframes = []
            return kfs
        kfs.clear()
        return ()

    # ------------------------------------------------------------------
    # Modes / lifecycle
    # ------------------------------------------------------------------
    def activate_localization_mode(self):
        self.localization_only = True
        self.tracker.localization_only = True

    def deactivate_localization_mode(self):
        self.localization_only = False
        self.tracker.localization_only = False

    @property
    def tracking_state(self) -> TrackingState:
        return self.tracker.state

    def reset(self):
        self._build()

    def shutdown(self):
        """Close the metrics log. The synchronous system has nothing
        running between calls; ``AsyncSlamSystem.shutdown`` also stops its
        workers."""
        if self.metrics_log is not None:
            self.metrics_log.close()

    # ------------------------------------------------------------------
    # Map persistence
    # ------------------------------------------------------------------
    def save_map(self, path: str):
        from .utils.checkpoint import save_map

        save_map(path, self.map, self.kfdb)

    def load_map(self, path: str, localization_only: bool = True):
        """Load a saved map (and its keyframe database); by default enter
        localization mode. Tracking is set LOST, so the next frame
        relocalizes against the loaded map."""
        from .utils.checkpoint import load_map

        self.map = load_map(path, self.cfg, self.kfdb, device=self.device)
        self.tracker.map = self.local_mapper.map = self.kfdb.map = self.map
        if self.loop_closer is not None:
            self.loop_closer.map = self.map
        # the tracker's local-map cache is keyed on (ref_kf, map.version),
        # which a new map can repeat
        self.tracker._local_cache_key = None
        if localization_only:
            self.activate_localization_mode()
        self.tracker.state = TrackingState.LOST
        kfs = self.map.valid_keyframes()
        self.tracker.ref_kf = int(kfs[0]) if len(kfs) else -1

    # ------------------------------------------------------------------
    # Trajectory export
    # ------------------------------------------------------------------
    def trajectory(self) -> List[Tuple[int, float, np.ndarray]]:
        return self.tracker.trajectory

    def keyframe_trajectory(self) -> List[Tuple[float, np.ndarray]]:
        m = self.map
        return [(float(m.kf_timestamp[k]), m.kf_pose[k].copy())
                for k in m.valid_keyframes()]

    @staticmethod
    def _write_tum(path: str, stamped_poses):
        """timestamp tx ty tz qx qy qz qw (camera-to-world), TUM format."""
        with open(path, "w") as f:
            for ts, Tcw in stamped_poses:
                Twc = np.linalg.inv(Tcw)
                q = geo.rotmat_to_quat(torch.from_numpy(
                    np.ascontiguousarray(Twc[:3, :3], np.float32))).numpy()
                t = Twc[:3, 3]
                f.write(
                    f"{ts:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                    f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n"
                )

    def save_trajectory_tum(self, path: str):
        self._write_tum(path, [(ts, T) for _, ts, T in self.tracker.trajectory])

    def save_keyframe_trajectory_tum(self, path: str):
        self._write_tum(path, self.keyframe_trajectory())

    def save_trajectory_kitti(self, path: str):
        """Row-major 3x4 Twc per line (KITTI format)."""
        with open(path, "w") as f:
            for _, _, Tcw in self.tracker.trajectory:
                Twc = np.linalg.inv(Tcw)
                f.write(" ".join(f"{v:.9e}" for v in Twc[:3, :4].reshape(-1)) + "\n")
