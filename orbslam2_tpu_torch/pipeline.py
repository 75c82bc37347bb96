"""The asynchronous system: the reference's three threads (port of
``orbslam2_tpu.pipeline``).

Tracking stays on the caller's thread (software-pipelined by default,
``Tracker.track_pipelined``); a local-mapping worker drains the keyframe
queue (culling, triangulation, fuse, local BA) and hands each finished
keyframe to a loop-closing worker (detection, Sim3, correction, essential
graph); global BA runs as a detached task with staged write-back
(``LoopCloser.launch_global_ba_background``). The synchronisation is the
reference package's:

  - the map is fixed-capacity arrays, read by the tracker without a lock
    (values may be one round stale, never structurally broken); structural
    changes happen under the map's one lock, which the workers take per
    phase around host reads and writes, never across device work;
  - back-pressure: while the mapping queue is not empty the tracker inserts
    only depth-urgent keyframes, and its idle-mapper keyframes are paced by
    the mapper's measured seconds a keyframe;
  - a keyframe that arrives during local BA interrupts it between LM
    chunks; under a backlog of two, fuse and BA are skipped (bounded).

Every thread launches on the device's current stream, so the kernels of the
tracker, the mapper and global BA run in the order they were queued: a
keyframe row the tracker writes into the device mirror is in place before a
mapping kernel queued after it reads it. Each worker runs under
``torch.cuda.device(device)``.

A worker that fails prints the traceback and goes on with the next
keyframe, as the reference's does; the port also keeps the first failure
(of a worker or of the global-BA task) and raises it on the caller's thread
at the next ``track_*`` call or at ``shutdown()``. Every wait on a worker
has a time limit and raises ``TimeoutError`` past it.
"""

from __future__ import annotations

import queue
import threading
import time
import traceback
from typing import Optional

from .device import on as on_device
from .system import SlamSystem

JOIN_S = 60.0       # a worker's stop, its queue emptied (its keyframe finishes)
DRAIN_S = 600.0     # a worker's stop after mapping every queued keyframe
GBA_JOIN_S = 300.0  # a running global BA at shutdown


class AsyncMappingMixin:
    """Adds the mapping and loop-closing workers to a SlamSystem."""

    _map_worker: Optional[threading.Thread] = None
    _worker_error = None  # (worker, keyframe, exception) of the first failure
    _error_lock = threading.Lock()

    def start_async_mapping(self: "SlamSystem"):
        if self._map_worker is not None:
            return
        self._kf_queue: "queue.Queue[Optional[int]]" = queue.Queue()
        self._loop_queue: "queue.Queue[Optional[int]]" = queue.Queue()
        self._map_worker = threading.Thread(
            target=self._mapping_loop, name="local-mapping", daemon=True)
        self._loop_worker = threading.Thread(
            target=self._loop_closing_loop, name="loop-closing", daemon=True)
        self._map_worker.start()
        self._loop_worker.start()
        self.tracker.mapping_busy = lambda: not self._kf_queue.empty()
        self.tracker.mapping_kf_cost = lambda: self.local_mapper.kf_proc_ema_s
        self.local_mapper.interrupt = lambda: not self._kf_queue.empty()
        self.local_mapper.backlog = lambda: self._kf_queue.qsize() >= 2
        if self.loop_closer is not None:
            self.loop_closer.background_gba = True

    def _worker_failed(self, worker: str, kf: int, e: Exception):
        traceback.print_exc()
        print(f"[{worker} worker] error on keyframe {kf}: {e!r}")
        with self._error_lock:
            if self._worker_error is None:
                self._worker_error = (worker, kf, e)

    def raise_worker_error(self):
        """Raise the first failure of a worker or of the global-BA task on
        the calling thread (once), if there was one."""
        closer = self.loop_closer
        with self._error_lock:
            err, self._worker_error = self._worker_error, None
            gba = None
            if closer is not None:
                gba, closer.gba_error = closer.gba_error, None
        if err is not None:
            worker, kf, e = err
            raise RuntimeError(f"the {worker} worker failed on keyframe {kf}") from e
        if gba is not None:
            raise RuntimeError("the global-BA task failed") from gba

    def _mapping_loop(self: "SlamSystem"):
        with on_device(self.device):
            while True:
                kf = self._kf_queue.get()
                if kf is None:
                    self._loop_queue.put(None)
                    return
                try:
                    t0 = time.perf_counter()
                    for phase in self.local_mapper.keyframe_phases(kf):
                        phase()
                    self.local_mapper.note_kf_processed(time.perf_counter() - t0)
                    if self.loop_closer is not None and self.map.kf_valid[kf]:
                        self._loop_queue.put(kf)
                except Exception as e:  # the worker's boundary: keep it alive
                    self._worker_failed("mapping", kf, e)

    def _loop_closing_loop(self: "SlamSystem"):
        with on_device(self.device):
            while True:
                kf = self._loop_queue.get()
                if kf is None:
                    return
                try:
                    # detection reads the map without the lock; the
                    # correction takes it (LoopCloser.process_keyframe)
                    self.loop_closer.process_keyframe(kf)
                except Exception as e:  # the worker's boundary: keep it alive
                    self._worker_failed("loop-closing", kf, e)

    def stop_async_mapping(self: "SlamSystem", drain: bool = True):
        """Stop the workers: with ``drain``, after the queued keyframes have
        been mapped and passed through loop closing; then join a running
        global BA."""
        if self._map_worker is None:
            return
        if not drain:  # the queued keyframes are dropped
            for q in (self._kf_queue, self._loop_queue):
                while True:
                    try:
                        q.get_nowait()
                    except queue.Empty:
                        break
        # the sentinel follows the queued keyframes through both workers
        self._kf_queue.put(None)
        limit = DRAIN_S if drain else JOIN_S
        for worker in (self._map_worker, self._loop_worker):
            worker.join(limit)
            if worker.is_alive():
                raise TimeoutError(f"the {worker.name} worker did not stop in {limit} s")
        if self.loop_closer is not None and not self.loop_closer.wait_global_ba(GBA_JOIN_S):
            raise TimeoutError(f"global BA did not end in {GBA_JOIN_S} s")
        self._map_worker = None
        self._loop_worker = None
        self.tracker.mapping_busy = lambda: False
        self.tracker.mapping_kf_cost = lambda: 0.0
        self.local_mapper.interrupt = lambda: False
        self.local_mapper.backlog = lambda: False


class AsyncSlamSystem(AsyncMappingMixin, SlamSystem):
    """SlamSystem with mapping, loop closing and global BA off the tracking
    thread.

    Tracking is pipelined by default (``pipelined_tracking=True``): each
    call dispatches the frame's device work and commits the oldest frame in
    flight once its result has reached the host. The pose returned is the
    freshest committed one: it lags the submitted frame by
    ``runtime.pipeline_depth`` to ``runtime.pipeline_depth_max`` frames
    (``tracker.pose_lag``); after initialization every call returns a pose
    unless tracking is lost. ``tracker.trajectory`` and
    ``save_trajectory_tum`` hold each frame's own pose. With
    ``pipelined_tracking=False`` each call returns its own frame's pose.
    """

    def __init__(self, *args, pipelined_tracking: bool = True, **kwargs):
        super().__init__(*args, **kwargs)
        self.pipelined_tracking = pipelined_tracking
        self.start_async_mapping()

    def _track(self, img, timestamp, depth, right_img=None):
        self.raise_worker_error()
        track = (self.tracker.track_pipelined if self.pipelined_tracking
                 else self.tracker.track)
        pose = track(img, timestamp, depth_map=depth, right_img=right_img)
        if self.tracker.reset_requested:
            # lost right after initialization: quiesce the workers against
            # the old map, rebuild, restart them on the new one
            self.stop_async_mapping(drain=False)
            self.reset()
            self.start_async_mapping()
            return pose
        for kf in self._drain_keyframes():
            self._kf_queue.put(kf)
        return pose

    def shutdown(self):
        """Commit the frames in flight, map and loop-close every queued
        keyframe, stop the workers and join global BA; then raise a worker's
        failure, if there was one."""
        self.tracker.flush_pipeline()
        for kf in self._drain_keyframes():
            self._kf_queue.put(kf)
        self.stop_async_mapping(drain=True)
        super().shutdown()
        self.raise_worker_error()
