"""SlamSystem facade — the public API (port of ``orbslam2_tpu.system``,
synchronous path).

Construction wires the map, the tracker and the local mapper onto one
``device``; ``track_rgbd``, ``track_stereo`` and ``track_monocular`` track
a frame and then run local mapping on every keyframe it created, in order.
Trajectories export in the TUM and KITTI formats. Loop closing (ROADMAP
queue 1, slice 8), map persistence and relocalization (slice 7) are not in
this slice.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .config import SlamConfig
from .device import DEFAULT as DEFAULT_DEVICE, resolve as resolve_device
from .local_mapping import LocalMapper
from .map.state import MapState
from .ops import geometry as geo
from .tracking import Tracker, TrackingState


class SlamSystem:
    def __init__(self, cfg: SlamConfig, enable_loop_closing: bool = False,
                 device=DEFAULT_DEVICE):
        if enable_loop_closing:
            raise NotImplementedError(
                "loop closing comes with ROADMAP queue 1, slice 8")
        self.cfg = cfg
        self.device = resolve_device(device)
        self._build()

    def _build(self):
        self.map = MapState.allocate(self.cfg, device=self.device)
        self.tracker = Tracker(self.cfg, self.map, device=self.device)
        self.local_mapper = LocalMapper(self.cfg, self.map, self.tracker.cam)

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
        kfs = self.tracker.pending_keyframes
        self.tracker.pending_keyframes = []
        for kf in kfs:
            self.local_mapper.process_keyframe(kf)
        return pose

    # ------------------------------------------------------------------
    # Modes / lifecycle
    # ------------------------------------------------------------------
    def activate_localization_mode(self):
        raise NotImplementedError(
            "localization mode needs relocalization, ROADMAP queue 1, slice 7")

    @property
    def tracking_state(self) -> TrackingState:
        return self.tracker.state

    def reset(self):
        self._build()

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
