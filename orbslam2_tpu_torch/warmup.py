"""Warm-up before the first frame (port of ``orbslam2_tpu.warmup``).

The reference pre-traces its jitted programs; nothing of that is needed
here. What a first frame on the card would pay instead is the kernel
library's build (nvcc, at first use) and each kernel's module load at its
first launch. ``warmup_system(slam)`` builds the library, then tracks two
rendered frames at the system's camera and extractor configuration on a
scratch system (its own map on the same device, loop closing off), the
second one pipelined (kernel R'), and runs one keyframe round of local
mapping and one BoW vector on it. The system handed in is not touched.
Monocular systems need two views with parallax to initialize; where those
two frames do not, the keyframe round is left out. Loop closing's kernels
are not warmed: loops are rare and their sizes depend on the map.
"""

from __future__ import annotations

import time

import torch


def warmup_system(slam) -> float:
    """Warm the kernels of ``slam``'s per-frame and per-keyframe paths;
    returns the seconds taken."""
    from .kernels import build
    from .system import SlamSystem
    from .tracking import TrackingState
    from .utils import slices

    t0 = time.perf_counter()
    if slam.device.type == "cuda":
        build.library()
    cfg = slam.cfg
    scratch = SlamSystem(cfg, enable_loop_closing=False, device=slam.device)
    tracker = scratch.tracker
    seq, _ = slices.frames(cfg.sensor, cfg, n=2)
    slices.track(scratch, cfg.sensor, seq[0], 0.0)
    if cfg.sensor == "rgbd":
        tracker.track_pipelined(seq[1][0], 1.0 / cfg.camera.fps, depth_map=seq[1][1])
    elif cfg.sensor == "stereo":
        tracker.track_pipelined(seq[1][0], 1.0 / cfg.camera.fps, right_img=seq[1][1])
    else:
        tracker.track_pipelined(seq[1], 1.0 / cfg.camera.fps)
    tracker.flush_pipeline()
    frame = tracker.last_frame
    if tracker.state == TrackingState.OK and frame.Tcw is not None:
        kfs = tracker.pending_keyframes or [tracker._create_keyframe(frame)]
        scratch.local_mapper.process_keyframe(kfs[-1])
        scratch.kfdb.add(kfs[-1])
    if slam.device.type == "cuda":
        torch.cuda.synchronize(slam.device)
    return time.perf_counter() - t0
