"""Tracking: per-frame pose estimation state machine (port of
``orbslam2_tpu.tracking``: RGB-D, stereo, monocular; synchronous and
pipelined).

The same FSM as the reference (NO_IMAGES_YET / NOT_INITIALIZED / OK / LOST),
motion-model + local-map tracking and the keyframe decision. Per frame:

  extract (ops.orb: kernels I, A, J, B) -> RGB-D: depth sampling and
  undistortion (kernel L); stereo: the right image's extraction, the
  row-band match (kernel V) and the SAD subpixel refinement (kernel W) ->
  fused cascade: up to four passes of projection and frustum gates (kernel
  O) / gated Hamming top-2 (kernel C) / match gates and claim resolution
  (kernel Q) / motion-only LM (kernel D), the retry decided on the device,
  then the packed result (kernel R) -> one copy to the host.

Monocular initialisation matches the frame against the reference frame by
SearchForInitialization (kernel U) and bootstraps the map from the
two-view initializer (kernel X); the reference-keyframe fallback matches
by kernel U too.

A LOST tracker relocalizes against the keyframe database: the frame's BoW
vector (kernel Y), the candidates, a mutual match against each candidate's
map points (kernel U without the rotation check), EPnP RANSAC over 256
host-drawn samples (kernel Z), then one or two projection passes (O, C, Q,
D and the pack, kernel R). Without a keyframe database a LOST tracker stays
lost, as the reference's does with ``kfdb=None``. In localization mode no
keyframe is made and a loss resets nothing; the last frame's close depths
become temporary points of the local map.

Pipelined tracking (``track_pipelined``) dispatches a frame before the
previous one has committed: the motion-model prediction is made on the
device from the previous dispatch's pose output (kernel R', the chained
cascade ``track_frame_fused_chained``), the packed result is copied into a
pinned host buffer without blocking, and the oldest frame in flight commits
once its copy has landed (``runtime.pipeline_depth`` frames behind, at most
``runtime.pipeline_depth_max``). Initialization, relocalization and loss
fall back to the synchronous path.
"""

from __future__ import annotations

import collections
import enum
import time
from types import SimpleNamespace
from typing import List, Optional, Tuple

import numpy as np
import torch

from .config import SlamConfig
from .device import DEFAULT as DEFAULT_DEVICE, HostCopy, upload
from .device import resolve as resolve_device
from .kernels import cascade_pack as _cascade_pack
from .kernels import claim_resolve as _claim_resolve
from .kernels import hamming as _hamming
from .kernels import match_rot as _match_rot
from .kernels import pnp_ransac as _pnp_ransac
from .kernels import pose_chain as _pose_chain
from .kernels import pose_lm as _pose_lm
from .kernels import project_gate as _project_gate
from .kernels import rgbd_depth as _rgbd_depth
from .kernels import stereo_sad as _stereo_sad
from .kernels import two_view as _two_view
from .map.state import MapState
from .models.camera import Camera, undistort_points
from .ops import matching, orb, pnp, pose_opt, stereo
from .ops.initializer import N_ITERS


class TrackingState(enum.Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    LOST = 3


class FrameData:
    """One processed frame: device-resident features + lazy host views."""

    def __init__(self, frame_id: int, timestamp: float, dev: dict, n: int):
        self.frame_id = frame_id
        self.timestamp = timestamp
        self.dev = dev                       # tensors per _FIELDS
        self.Tcw: Optional[np.ndarray] = None
        self.mp = np.full(n, -1, np.int32)   # matched map point per feature
        self._host: dict = {}

    def _pull(self, key: str) -> np.ndarray:
        if key not in self._host:
            self._host[key] = self.dev[key].cpu().numpy()
        return self._host[key]

    xy = property(lambda self: self._pull("xy"))
    desc = property(lambda self: self._pull("desc"))
    octave = property(lambda self: self._pull("octave"))
    angle = property(lambda self: self._pull("angle"))
    valid = property(lambda self: self._pull("valid"))
    ur = property(lambda self: self._pull("ur"))
    depth = property(lambda self: self._pull("depth"))


# ---------------------------------------------------------------------------
# Tracking cascade: project local points -> gated match -> claims -> pose LM
# ---------------------------------------------------------------------------

# the cascade's kernels (each runs its plain version on CPU tensors), and
# the plain versions alone, which chip_smoke.py runs on the card as the
# cascade's reference
_KERNELS = SimpleNamespace(
    project_gate=_project_gate.project_gate,
    hamming_top2_gated=_hamming.hamming_top2_gated,
    claim_resolve=_claim_resolve.claim_resolve, pose_lm=_pose_lm.pose_lm,
    cascade_pack=_cascade_pack.cascade_pack, pose_chain=_pose_chain.pose_chain)
_PLAIN = SimpleNamespace(
    project_gate=_project_gate.project_gate_plain,
    hamming_top2_gated=_hamming.hamming_top2_gated_plain,
    claim_resolve=_claim_resolve.claim_resolve_plain,
    pose_lm=_pose_lm.pose_lm_plain,
    cascade_pack=_cascade_pack.cascade_pack_plain,
    pose_chain=_pose_chain.pose_chain_plain)


def project_match(k, cam: Camera, Tcw, mp_pos, mp_desc, mp_valid, mp_normal,
                  mp_dmin, mp_dmax, kp_xy, kp_desc, kp_octave, kp_valid, kp_ur,
                  radius: float, scale_factor: float, n_levels: int, gate=None,
                  max_dist: int = matching.TH_HIGH, nn_ratio: float = 0.9):
    """One SearchByProjection through the functions of ``k`` (_KERNELS or
    _PLAIN): projection and gates (O), gated Hamming top-2 (C), match gates
    (``max_dist``, ``nn_ratio``) and claims (Q). Returns (Projection,
    Claims)."""
    pr = k.project_gate(cam, Tcw, mp_pos, mp_valid, mp_normal, mp_dmin,
                        mp_dmax, radius, scale_factor, n_levels, gate=gate)
    top2 = k.hamming_top2_gated(mp_desc, pr.proj, pr.r_px, pr.pred_level,
                                pr.ur_pred, pr.row_valid, kp_desc, kp_xy,
                                kp_octave, kp_valid, kp_ur, gate=gate)
    claims = k.claim_resolve(*top2, pr.row_valid, kp_xy, kp_octave, kp_ur,
                             scale_factor, max_dist, nn_ratio, gate=gate)
    return pr, claims


def track_against_points(
    cam: Camera, Tcw_pred, mp_pos, mp_desc, mp_valid, mp_normal, mp_dmin,
    mp_dmax, kp_xy, kp_desc, kp_octave, kp_valid, kp_ur, kp_depth,
    radius: float, scale_factor: float, n_levels: int, max_dist: int,
    nn_ratio: float,
) -> torch.Tensor:
    """One SearchByProjection at ``radius`` with the caller's ``max_dist``
    and ``nn_ratio``, then the pose LM: kernels O, C, Q, D. The result is
    packed by kernel R as the cascade's (its one pass given as both of R's
    candidates, so Tcw, n_final and the per-point codes are the pass's),
    for one copy to the host."""
    pr, cl = project_match(_KERNELS, cam, Tcw_pred, mp_pos, mp_desc, mp_valid,
                           mp_normal, mp_dmin, mp_dmax, kp_xy, kp_desc, kp_octave,
                           kp_valid, kp_ur, radius, scale_factor, n_levels,
                           max_dist=max_dist, nn_ratio=nn_ratio)
    T, inl, n, _ = _pose_lm.pose_lm(Tcw_pred, cam, mp_pos, cl.obs, cl.sigma2, cl.keep)
    return _cascade_pack.cascade_pack(T, n, inl, cl.kp_of_mp, T, n, inl, cl.kp_of_mp,
                                      n, pr.row_valid, kp_valid, kp_depth, 0.0)


def track_frame_fused(
    cam: Camera, Tcw_pred, mp_pos, mp_desc, mp_valid, mp_normal, mp_dmin,
    mp_dmax, kp_xy, kp_desc, kp_octave, kp_valid, kp_ur, kp_depth,
    th_depth: float, radius: float, scale_factor: float, n_levels: int,
    min_inliers_track: int, plain: bool = False,
) -> torch.Tensor:
    """The whole per-frame tracking cascade; returns the packed result
    [Tcw(16), n_motion, n_final, n_tracked_close, n_untracked_close,
    code per point (P)] as one (20 + P,) float32 tensor.

    Passes: motion model at ``radius``, retried at 2x when it admits fewer
    than ``min_inliers_track`` inliers, a local-map pass at 4 px from the
    refined pose and a tight pass at 2 px, keeping the better of the last
    two (kernel R). The per-point code is (kp_idx + 1) * 4 + inlier * 2 +
    frustum. Each pass is kernels O, C, Q, D. The retry is decided on the
    device: its launches read pass 1's inlier count and return at once
    unless it is below the threshold, and its pose and count overwrite pass
    1's; every pose stays on the device, so on the card the host waits only
    for the caller's one copy of the result. ``plain`` runs the kernels'
    plain versions on any device.
    """
    k = _PLAIN if plain else _KERNELS
    mp = (mp_pos, mp_desc, mp_valid, mp_normal, mp_dmin, mp_dmax)
    kp = (kp_xy, kp_desc, kp_octave, kp_valid, kp_ur)

    def run(Tcw, r, gate=None, out=None):
        pr, cl = project_match(k, cam, Tcw, *mp, *kp, r, scale_factor,
                               n_levels, gate)
        T, inl, n, _ = k.pose_lm(Tcw, cam, mp_pos, cl.obs, cl.sigma2, cl.keep,
                                 gate=gate, out=out)
        return T, inl, n, cl.kp_of_mp, pr.row_valid

    T1, _, n1, _, _ = run(Tcw_pred, radius)
    run(Tcw_pred, 2.0 * radius, gate=(n1, min_inliers_track), out=(T1, n1))
    T2, inl2, n2, kp2, frustum2 = run(T1, 4.0)
    T3, inl3, n3, kp3, _ = run(T2, 2.0)
    return k.cascade_pack(T2, n2, inl2, kp2, T3, n3, inl3, kp3, n1, frustum2,
                          kp_valid, kp_depth, th_depth)


def track_frame_fused_chained(
    cam: Camera, Tcw_prev, Tcw_prev2, have_motion: bool, mp_pos, mp_desc,
    mp_valid, mp_normal, mp_dmin, mp_dmax, kp_xy, kp_desc, kp_octave,
    kp_valid, kp_ur, kp_depth, th_depth: float, base_radius: float,
    scale_factor: float, n_levels: int, min_inliers_track: int,
    plain: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cascade with the motion-model prediction made on the device from
    the pose chain (Tcw_prev, the previous dispatch's pose, possibly still
    being computed; Tcw_prev2, the one before): kernel R' re-projects both
    links onto SE(3) and predicts vel Tcw_prev (Tcw_prev alone without a
    motion model, at twice ``base_radius``), then ``track_frame_fused``
    (O, C, Q, D, R), then R' orthonormalizes the packed pose into the next
    link. Returns (packed, Tcw): the link stays on the device to seed the
    next dispatch."""
    k = _PLAIN if plain else _KERNELS
    T_pred = k.pose_chain(Tcw_prev, Tcw_prev2, have_motion)
    radius = base_radius if have_motion else 2.0 * base_radius
    packed = track_frame_fused(
        cam, T_pred, mp_pos, mp_desc, mp_valid, mp_normal, mp_dmin, mp_dmax,
        kp_xy, kp_desc, kp_octave, kp_valid, kp_ur, kp_depth, th_depth,
        radius, scale_factor, n_levels, min_inliers_track, plain=plain)
    return packed, k.pose_chain(packed[:16].view(4, 4))


def match_frames_windowed(desc_a, xy_a, angle_a, valid_a, desc_b, xy_b,
                          angle_b, valid_b, window: float, nn_ratio: float = 0.9
                          ) -> matching.MatchResult:
    """SearchForInitialization: windowed + ratio + rotation-checked mutual
    match (kernel U)."""
    return _match_rot.match_rot(desc_a, desc_b, valid_a, valid_b, angle_a,
                                angle_b, matching.TH_LOW, nn_ratio, xy_a=xy_a,
                                xy_b=xy_b, window=window)


# ---------------------------------------------------------------------------
# Tracker
# ---------------------------------------------------------------------------

class Tracker:
    def __init__(self, cfg: SlamConfig, slam_map: MapState, kfdb=None,
                 device=DEFAULT_DEVICE):
        self.cfg = cfg
        self.map = slam_map
        self.kfdb = kfdb  # keyframe database (relocalization); optional
        self.device = resolve_device(device)
        cc = cfg.camera
        self.cam = Camera.create(
            cc.fx, cc.fy, cc.cx, cc.cy, cc.k1, cc.k2, cc.p1, cc.p2, cc.k3,
            bf=cc.bf, width=cc.width, height=cc.height,
        )
        self.extractor = orb.OrbExtractor(cfg.extractor, cc.height, cc.width,
                                          device=self.device)
        self._fx, self._fy = float(cc.fx), float(cc.fy)
        self._cx, self._cy = float(cc.cx), float(cc.cy)
        self._baseline = float(cc.bf) / max(float(cc.fx), 1e-8)
        self.state = TrackingState.NO_IMAGES_YET
        self.velocity: Optional[np.ndarray] = None
        self.last_frame: Optional[FrameData] = None
        self.ref_kf: int = -1
        self.last_kf_frame_id: int = -1000
        self.frame_id: int = 0
        self._next_frame_id: int = 0
        self.n_inliers_last: int = 0
        self.n_tracked_close: int = 0
        self.n_untracked_close: int = 0
        self.local_point_cap = int(cfg.tracking.local_map_point_cap)
        self.trajectory: List[Tuple[int, float, np.ndarray]] = []
        self.metrics: List[dict] = []
        self.metrics_log = None  # optional utils.telemetry.MetricsLog
        self.reset_requested = False
        self.localization_only = False  # no keyframes, no map growth
        self.pending_keyframes: List[int] = []
        self.init_ref: Optional[FrameData] = None  # monocular init reference
        # the asynchronous system's hooks: a keyframe waits in the mapping
        # queue (back-pressure), and the mapper's seconds a keyframe (pace)
        self.mapping_busy = lambda: False
        self.mapping_kf_cost = lambda: 0.0
        # pipelined tracking: the frames in flight, (frame, sel, HostCopy of
        # the packed result, t_start), oldest first; the pose chain on the
        # device (Tcw_prev, Tcw_prev2); the pinned buffers the results are
        # copied into; whether the last commit took the fallback
        self._pending: "collections.deque" = collections.deque()
        self._chain: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._ring: List[torch.Tensor] = []
        self._ring_next = 0
        self._fallback_used = False
        # frames the pose last returned by track_pipelined lags its frame
        self.pose_lag = 0
        self._rng = np.random.default_rng(cfg.runtime.seed)
        self._neg_ones: Optional[torch.Tensor] = None
        self._local_cache_key = None
        self._local_n_used = 0  # rows of the cached local map holding points
        # per-octave scale of the stereo row gate, as the reference's
        # float32 array of the config's float64 powers
        self._scale_factors = torch.from_numpy(np.asarray(
            cfg.extractor.scale_factors, np.float32)).to(self.device)

    def _f32(self, v) -> float:
        return float(np.float32(v))

    # ------------------------------------------------------------------
    def _make_frame(self, img: np.ndarray, timestamp: float,
                    depth_map: Optional[np.ndarray] = None,
                    right_img: Optional[np.ndarray] = None) -> FrameData:
        if right_img is not None:
            # the level-0 images stay on the device for kernel W
            img = upload(np.asarray(img, np.float32), self.device)
        feats = self.extractor(img)
        n = feats.xy.shape[0]
        if self._neg_ones is None or self._neg_ones.shape[0] != n:
            self._neg_ones = torch.full((n,), -1.0, device=self.device)
        dev = dict(
            xy=feats.xy, desc=feats.desc, octave=feats.octave,
            angle=feats.angle, valid=feats.valid,
            ur=self._neg_ones, depth=self._neg_ones,
        )
        if depth_map is None and self.cam.has_distortion:
            dev["xy"] = undistort_points(self.cam, feats.xy)
        if right_img is not None:
            # stereo: the right image's features, matched along epipolar
            # rows (kernel V) and refined to subpixel (kernel W)
            right = upload(np.asarray(right_img, np.float32), self.device)
            feats_r = self.extractor(right)
            ur0, depth0 = stereo.stereo_match(
                feats, feats_r, self.cam.bf, self._f32(self._baseline),
                self._scale_factors)
            dev["ur"], dev["depth"] = _stereo_sad.stereo_sad(
                img, right, feats.xy, ur0, depth0, self.cam.bf)
        elif depth_map is not None:
            # millimetre quantization and stride subsampling as the reference
            # uploads the depth map, so both packages read the same depths
            d = np.asarray(depth_map, np.float32)
            scale = np.float32(1e3)
            stride = max(int(self.cfg.runtime.depth_upload_stride), 1)
            if stride > 1:
                d = d[::stride, ::stride]
            d_u16 = np.where(
                (d > 0) & (d * scale < 65535.0), d * scale, 0.0
            ).astype(np.uint16)
            # kernel L: (xy_undist, ur, depth) of the keypoints from the
            # uint16 upload; it also undistorts them
            dev["xy"], dev["ur"], dev["depth"] = _rgbd_depth.rgbd_depth(
                upload(d_u16, self.device), self._f32(1.0 / scale),
                feats.xy, feats.valid, self.cam, stride=stride,
            )
        fid = self._next_frame_id
        self._next_frame_id += 1
        return FrameData(fid, timestamp, dev, n)

    # ------------------------------------------------------------------
    def track(self, img: np.ndarray, timestamp: float,
              depth_map: Optional[np.ndarray] = None,
              right_img: Optional[np.ndarray] = None) -> Optional[np.ndarray]:
        """Process one frame; returns Tcw when tracked (else None)."""
        t_start = time.perf_counter()
        frame = self._make_frame(img, timestamp, depth_map, right_img)
        return self._track_core(frame, t_start)

    def _track_core(self, frame: FrameData, t_start: float) -> Optional[np.ndarray]:
        new_kf = None
        # a synchronous excursion drives the pose from host state: the
        # device chain is stale from here
        self._chain = None
        if self.state == TrackingState.NO_IMAGES_YET:
            self.state = TrackingState.NOT_INITIALIZED

        if self.state == TrackingState.NOT_INITIALIZED:
            if self.cfg.sensor != "monocular":
                ok = self._initialize_rgbd(frame)
            else:
                ok = self._initialize_monocular(frame)
            if ok:
                self.state = TrackingState.OK
        else:
            if self.state == TrackingState.LOST:
                ok = self._relocalize(frame)
            else:
                ok = self._track_frame(frame)
            new_kf = self._handle_result(frame, ok)

        self._finalize_frame(frame, new_kf, t_start)
        return frame.Tcw

    def _handle_result(self, frame: FrameData, ok: bool) -> Optional[int]:
        new_kf = None
        if ok:
            self.state = TrackingState.OK
            if not self.localization_only and self._need_new_keyframe(frame):
                new_kf = self._create_keyframe(frame)
        else:
            self.state = TrackingState.LOST
            # lost right after initialization: the bootstrap map is junk,
            # request a full reset instead of relocalizing against it
            if not self.localization_only and int(self.map.kf_valid.sum()) <= 5:
                self.reset_requested = True
        return new_kf

    def _finalize_frame(self, frame: FrameData, new_kf: Optional[int],
                        t_start: float):
        if frame.Tcw is not None:
            self.trajectory.append(
                (frame.frame_id, frame.timestamp, frame.Tcw.copy()))
        if self.last_frame is not None and frame.Tcw is not None and \
                self.last_frame.Tcw is not None:
            self.velocity = frame.Tcw @ np.linalg.inv(self.last_frame.Tcw)
        elif frame.Tcw is None:
            self.velocity = None
        self.last_frame = frame
        self.frame_id = frame.frame_id + 1
        if new_kf is not None:
            self.pending_keyframes.append(new_kf)
        if self.metrics_log is not None:
            # one record a committed frame, on the synchronous and the
            # pipelined commit alike (track_ms from the frame's dispatch)
            self.metrics_log.emit(
                frame=frame.frame_id,
                state=self.state.name,
                inliers=self.n_inliers_last,
                kf=new_kf if new_kf is not None else -1,
                track_ms=round((time.perf_counter() - t_start) * 1000, 2),
            )

    # ------------------------------------------------------------------
    # Pipelined tracking: commit behind the dispatch
    # ------------------------------------------------------------------
    def track_pipelined(self, img: np.ndarray, timestamp: float,
                        depth_map: Optional[np.ndarray] = None,
                        right_img: Optional[np.ndarray] = None
                        ) -> Optional[np.ndarray]:
        """Dispatch this frame's device work, retire the oldest frame(s) in
        flight, and return the freshest committed pose. It lags the
        dispatched frame by ``runtime.pipeline_depth`` to
        ``runtime.pipeline_depth_max`` frames (``self.pose_lag``, the lag of
        the value just returned) and is None only before initialization or
        across a loss; ``self.trajectory`` holds each frame's own pose once
        it commits. Initialization, relocalization and loss take the
        synchronous path: their control flow needs the frame's result."""
        t_start = time.perf_counter()
        frame = self._make_frame(img, timestamp, depth_map, right_img)
        if self.state in (TrackingState.NO_IMAGES_YET,
                          TrackingState.NOT_INITIALIZED, TrackingState.LOST):
            self.flush_pipeline()
            self.pose_lag = 0
            return self._track_core(frame, t_start)
        # dispatch first: the prediction comes from the chain on the device,
        # so it does not wait for the previous frame's commit
        sel, packed = self._dispatch_track_chained(frame)
        self._pending.append((frame, sel, self._start_copy(packed), t_start))
        depth, depth_max = self._depths()
        # past depth_max a commit waits for its copy; between depth and
        # depth_max a frame retires only once its copy has landed, so a
        # slow copy stretches the queue instead of stalling the dispatch
        while len(self._pending) > depth_max:
            self._commit_pending_one()
        while len(self._pending) > depth and self._pending[0][2].done():
            self._commit_pending_one()
        if self.last_frame is not None and self.last_frame.Tcw is not None:
            self.pose_lag = frame.frame_id - self.last_frame.frame_id
            return self.last_frame.Tcw
        self.pose_lag = 0
        return None

    def _depths(self) -> Tuple[int, int]:
        rt = self.cfg.runtime
        depth = max(int(rt.pipeline_depth), 1)
        return depth, max(int(rt.pipeline_depth_max), depth)

    def _start_copy(self, packed: torch.Tensor) -> HostCopy:
        """Start the packed result's copy to the host. On the card it goes
        into the next of pipeline_depth_max + 1 pinned buffers: at most
        pipeline_depth_max frames are in flight when a frame is dispatched,
        so a buffer is written again only after its frame has committed."""
        if packed.device.type != "cuda":
            return HostCopy(packed)
        n = self._depths()[1] + 1
        if len(self._ring) != n or self._ring[0].shape != packed.shape:
            self._ring = [torch.empty(packed.shape, dtype=packed.dtype,
                                      pin_memory=True) for _ in range(n)]
        buf = self._ring[self._ring_next % n]
        self._ring_next += 1
        return HostCopy(packed, into=buf)

    def _commit_pending_one(self) -> Optional[np.ndarray]:
        if not self._pending:
            return None
        frame, sel, copy, t_start = self._pending.popleft()
        self._fallback_used = False
        ok = self._finish_track(frame, sel, copy.result())
        new_kf = self._handle_result(frame, ok)
        self._finalize_frame(frame, new_kf, t_start)
        if self._fallback_used and self._pending:
            # the committed frame's result was rejected: every frame still
            # in flight was predicted off the same broken chain, so each is
            # tracked again, in order, from host predictions (its features
            # are still on the device)
            self._chain = None
            stale = list(self._pending)
            self._pending.clear()
            for f2, _, _, t2 in stale:
                self._track_core(f2, t2)
        return frame.Tcw

    def flush_pipeline(self) -> Optional[np.ndarray]:
        """Commit every frame in flight (before reading the trajectory or
        the state at shutdown, or on a control-flow transition)."""
        pose = None
        while self._pending:
            pose = self._commit_pending_one()
        return pose

    # ------------------------------------------------------------------
    # Initialization
    # ------------------------------------------------------------------
    def _initialize_monocular(self, frame: FrameData) -> bool:
        """Two-view initialization against the reference frame
        (Tracking::MonocularInitialization): SearchForInitialization
        (kernel U), minimal sets drawn on the host, the initializer
        (kernel X, one copy of its packed result), then the median-depth
        normalisation and the two keyframes (CreateInitialMapMonocular)."""
        if self.init_ref is None or self.init_ref.valid.sum() < 100:
            self.init_ref = frame
            return False
        ref = self.init_ref
        res = match_frames_windowed(
            ref.dev["desc"], ref.dev["xy"], ref.dev["angle"], ref.dev["valid"],
            frame.dev["desc"], frame.dev["xy"], frame.dev["angle"],
            frame.dev["valid"], 100.0, nn_ratio=0.9)
        m_valid = res.valid.cpu().numpy()
        m_idx = res.idx.cpu().numpy()
        if m_valid.sum() < 100:
            self.init_ref = frame  # reference too stale, restart
            return False

        x1 = ref.xy
        x2 = np.where(m_valid[:, None], frame.xy[np.maximum(m_idx, 0)], 0.0)
        vidx = np.where(m_valid)[0]
        # distinct correspondences per minimal set, in the reference's draw
        order = np.argsort(self._rng.random((N_ITERS, len(vidx))), axis=1)[:, :8]
        samples = vidx[order].astype(np.int32)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        packed = _two_view.two_view(
            t(x1.astype(np.float32)), t(x2.astype(np.float32)), t(m_valid),
            self.cam.K, t(samples))
        init = _two_view.unpack(packed.cpu().numpy(), len(m_valid))
        if not init.success:
            return False
        good = init.good
        pts3d = init.points3d.copy()
        T21 = init.T21.copy()

        # normalize scale: median depth -> 1 (CreateInitialMapMonocular)
        med_depth = float(np.median(pts3d[good][:, 2]))
        if med_depth <= 0:
            return False
        pts3d = pts3d / med_depth
        T21[:3, 3] /= med_depth

        m = self.map
        kf0 = m.add_keyframe(
            np.eye(4, dtype=np.float32), ref.xy, ref.desc, ref.octave, ref.angle,
            ref.valid, ref.frame_id, ref.timestamp, ur=ref.ur, depth=ref.depth)
        kf1 = m.add_keyframe(
            T21.astype(np.float32), frame.xy, frame.desc, frame.octave,
            frame.angle, frame.valid, frame.frame_id, frame.timestamp,
            ur=frame.ur, depth=frame.depth)
        new_mps = []
        for i in np.where(good)[0]:
            mp = m.add_map_point(pts3d[i], kf0)
            m.add_observation(mp, kf0, int(i))
            m.add_observation(mp, kf1, int(m_idx[i]))
            frame.mp[m_idx[i]] = mp
            new_mps.append(mp)
        m.update_point_attributes(np.asarray(new_mps))
        m.update_connections(kf1)
        m.update_connections(kf0)

        frame.Tcw = T21
        self.ref_kf = kf1
        self.last_kf_frame_id = frame.frame_id
        self.init_ref = None
        self.n_inliers_last = len(new_mps)
        return True

    def _initialize_rgbd(self, frame: FrameData) -> bool:
        """RGB-D init: spawn map points for all features with depth
        (Tracking::StereoInitialization)."""
        ok = frame.valid & (frame.depth > 0)
        if ok.sum() < 100:
            return False
        m = self.map
        frame.Tcw = np.eye(4, dtype=np.float32)
        kf0 = m.add_keyframe(
            frame.Tcw, frame.xy, frame.desc, frame.octave, frame.angle,
            frame.valid, frame.frame_id, frame.timestamp, ur=frame.ur,
            depth=frame.depth,
        )
        fx, fy, cx, cy = self._fx, self._fy, self._cx, self._cy
        new_mps = []
        for i in np.where(ok)[0]:
            d = frame.depth[i]
            x = (frame.xy[i, 0] - cx) / fx * d
            y = (frame.xy[i, 1] - cy) / fy * d
            mp = m.add_map_point(np.array([x, y, d], np.float32), kf0)
            m.add_observation(mp, kf0, int(i))
            frame.mp[i] = mp
            new_mps.append(mp)
        m.update_point_attributes(np.asarray(new_mps))
        m.update_connections(kf0)
        self.ref_kf = kf0
        self.last_kf_frame_id = frame.frame_id
        self.n_inliers_last = len(new_mps)
        return True

    # ------------------------------------------------------------------
    # Frame-to-map tracking
    # ------------------------------------------------------------------
    def _gather_local_points(self) -> Tuple[np.ndarray, dict]:
        """Local map = points observed by the reference KF's covisibility
        neighbourhood, padded to a fixed capacity and cached on
        (ref_kf, map version)."""
        m = self.map
        key = (self.ref_kf, m.version)
        if self._local_cache_key == key:
            return self._local_cache
        kfs = [self.ref_kf] + [int(k) for k in m.covisible_keyframes(self.ref_kf)]
        # id-sorted: on a tie the matcher prefers the lower index, the
        # older (better estimated) point
        mp_ids = np.unique(m.kf_mp[kfs])
        mp_ids = mp_ids[mp_ids >= 0]
        mp_ids = mp_ids[m.mp_valid[mp_ids]]
        if len(mp_ids) > self.local_point_cap:
            # overflow: keep the points of the strongest covisible
            # keyframes, then id-sort the kept subset
            cat = m.kf_mp[kfs].ravel()
            cat = cat[cat >= 0]
            _, first = np.unique(cat, return_index=True)
            ordered = cat[np.sort(first)]
            ordered = ordered[m.mp_valid[ordered]]
            n_drop = len(ordered) - self.local_point_cap
            mp_ids = np.sort(ordered[: self.local_point_cap])
            print(f"[track] local map overflow: {n_drop} weakest-covis "
                  f"points dropped (cap {self.local_point_cap})")
        P = self.local_point_cap
        sel = np.zeros(P, np.int64)
        sel[: len(mp_ids)] = mp_ids
        valid = np.zeros(P, bool)
        valid[: len(mp_ids)] = True
        dev = self.device
        buf = dict(
            pos=upload(m.mp_pos[sel], dev), desc=upload(m.mp_desc[sel], dev),
            valid=upload(valid, dev), normal=upload(m.mp_normal[sel], dev),
            dmin=upload(m.mp_dmin[sel], dev), dmax=upload(m.mp_dmax[sel], dev),
        )
        self._local_cache_key = key
        self._local_cache = (sel, buf)
        self._local_n_used = len(mp_ids)
        return sel, buf

    def _augment_vo_points(self, sel: np.ndarray, buf: dict):
        """Localization-mode visual-odometry points (UpdateLastFrame): the
        last frame's close unmatched depths, unprojected into TEMPORARY
        points in the free tail of a copy of the local buffer (sel -1, never
        committed to the map), so tracking survives where the saved map is
        sparse."""
        lf = self.last_frame
        if (lf is None or lf.Tcw is None or not (lf.depth > 0).any()):
            return sel, buf
        free = self.local_point_cap - self._local_n_used
        if free <= 0:
            return sel, buf
        cand = np.where(lf.valid & (lf.depth > 0) & (lf.mp < 0))[0]
        if len(cand) == 0:
            return sel, buf
        th_depth = self.cfg.camera.th_depth * self._baseline
        order = cand[np.argsort(lf.depth[cand])]
        close = order[lf.depth[order] < th_depth]
        # the close points, or the nearest 100 when the scene is all far
        spawn = (close if len(close) >= 100 else order[:100])[:free]
        Twc = np.linalg.inv(lf.Tcw)
        fx, fy, cx, cy = self._fx, self._fy, self._cx, self._cy
        d = lf.depth[spawn][:, None]
        pc = np.concatenate(
            [(lf.xy[spawn, :1] - cx) / fx * d,
             (lf.xy[spawn, 1:2] - cy) / fy * d, d], axis=1).astype(np.float32)
        pw = pc @ Twc[:3, :3].T + Twc[:3, 3]
        center = Twc[:3, 3]
        dist = np.linalg.norm(pw - center, axis=1)
        normal = (pw - center) / np.maximum(dist, 1e-9)[:, None]
        rows = np.arange(self._local_n_used, self._local_n_used + len(spawn))
        new = dict(pos=pw, desc=lf.desc[spawn], valid=np.ones(len(spawn), bool),
                   normal=normal, dmin=dist / 2.0, dmax=dist * 2.0)
        # a copy: the cached buffer serves the next frame unchanged
        idx = torch.from_numpy(rows).to(self.device)
        buf = {k: v.index_copy(0, idx, torch.from_numpy(
            np.ascontiguousarray(new[k])).to(self.device, v.dtype))
            for k, v in buf.items()}
        sel = sel.copy()
        sel[rows] = -1
        return sel, buf

    def _run_fused(self, frame: FrameData, Tcw_pred: np.ndarray, buf: dict,
                   radius: float) -> torch.Tensor:
        cfge = self.cfg.extractor
        return track_frame_fused(
            self.cam, upload(np.asarray(Tcw_pred, np.float32), self.device),
            buf["pos"], buf["desc"], buf["valid"], buf["normal"],
            buf["dmin"], buf["dmax"],
            frame.dev["xy"], frame.dev["desc"], frame.dev["octave"],
            frame.dev["valid"], frame.dev["ur"], frame.dev["depth"],
            self._f32(self.cfg.camera.th_depth * self._baseline),
            self._f32(radius), self._f32(cfge.scale_factor), cfge.n_levels,
            self.cfg.tracking.min_inliers_track,
        )

    @staticmethod
    def _decode(packed):
        """Split a packed result of kernel R (one D2H copy): Tcw, n_motion,
        n_final, the close-point census, inliers, kp_of_mp, frustum."""
        p = packed.cpu().numpy()
        code = p[20:].astype(np.int32)
        return (p[:16].reshape(4, 4).astype(np.float32), int(p[16]), int(p[17]),
                (int(p[18]), int(p[19])), (code & 2) > 0, (code >> 2) - 1,
                (code & 1) > 0)

    def _unpack_fused(self, packed):
        """Split the packed cascade result (the frame's single D2H copy)."""
        Tcw, n_motion, n_final, census, inl, kp_of_mp, frustum = self._decode(packed)
        self.n_tracked_close, self.n_untracked_close = census
        return Tcw, n_motion, n_final, inl, kp_of_mp, frustum

    def _dispatch_track(self, frame: FrameData):
        """Run the fused cascade for one frame from the motion model
        (falling back to the last pose at twice the radius)."""
        m = self.map
        sel, buf = self._gather_local_points()
        if self.localization_only:
            sel, buf = self._augment_vo_points(sel, buf)
        if self.velocity is not None and self.last_frame.Tcw is not None:
            Tcw_pred = self.velocity @ self.last_frame.Tcw
            radius = self.cfg.tracking.motion_model_radius
        else:
            Tcw_pred = (
                self.last_frame.Tcw
                if self.last_frame and self.last_frame.Tcw is not None
                else m.kf_pose[self.ref_kf]
            )
            radius = 2.0 * self.cfg.tracking.motion_model_radius
        return sel, self._run_fused(frame, Tcw_pred, buf, radius)

    def _dispatch_track_chained(self, frame: FrameData):
        """Dispatch the chained cascade: the prediction is made on the
        device from the previous dispatch's pose output, so the dispatch
        never waits for a copy to the host. After a synchronous excursion
        (initialization, relocalization, fallback) the chain is seeded from
        the host's last pose and velocity."""
        sel, buf = self._gather_local_points()
        if self.localization_only:
            sel, buf = self._augment_vo_points(sel, buf)
        if self._chain is not None:
            Tcw_prev, Tcw_prev2 = self._chain
            have_motion = True
        else:
            last = (self.last_frame.Tcw
                    if self.last_frame is not None and self.last_frame.Tcw is not None
                    else self.map.kf_pose[self.ref_kf])
            Tcw_prev = upload(np.asarray(last, np.float32), self.device)
            have_motion = self.velocity is not None
            Tcw_prev2 = (upload((np.linalg.inv(self.velocity) @ last).astype(np.float32),
                                self.device) if have_motion else Tcw_prev)
        cfge = self.cfg.extractor
        packed, Tcw_out = track_frame_fused_chained(
            self.cam, Tcw_prev, Tcw_prev2, have_motion,
            buf["pos"], buf["desc"], buf["valid"], buf["normal"], buf["dmin"],
            buf["dmax"], frame.dev["xy"], frame.dev["desc"], frame.dev["octave"],
            frame.dev["valid"], frame.dev["ur"], frame.dev["depth"],
            self._f32(self.cfg.camera.th_depth * self._baseline),
            self._f32(self.cfg.tracking.motion_model_radius),
            self._f32(cfge.scale_factor), cfge.n_levels,
            self.cfg.tracking.min_inliers_track)
        self._chain = (Tcw_out, Tcw_prev)
        return sel, packed

    def _track_frame(self, frame: FrameData) -> bool:
        sel, packed = self._dispatch_track(frame)
        return self._finish_track(frame, sel, packed)

    def _finish_track(self, frame: FrameData, sel, packed) -> bool:
        Tcw2, n_inl, n_inl2, inl, kp_of_mp, frustum = self._unpack_fused(packed)
        if (n_inl < self.cfg.tracking.min_inliers_track
                or n_inl2 < self.cfg.tracking.min_inliers_local_map):
            # fall back to matching against the reference keyframe
            # (Tracking::TrackReferenceKeyFrame); the pose chain is no
            # longer to be trusted
            self._fallback_used = True
            self._chain = None
            return self._track_reference_keyframe(frame)
        self._commit_track(frame, sel, Tcw2, n_inl, n_inl2, inl, kp_of_mp,
                           frustum)
        return True

    def _commit_track(self, frame, sel, Tcw, n_motion, n_final, inl,
                      kp_of_mp, frustum):
        m = self.map
        frame.Tcw = Tcw
        frame.mp[:] = -1
        matched_rows = np.where(inl & (sel >= 0))[0]
        frame.mp[kp_of_mp[matched_rows]] = sel[matched_rows]
        # visibility statistics for the found/visible culling ratio
        m.mp_visible[sel[frustum & (sel >= 0)]] += 1
        m.mp_found[sel[matched_rows]] += 1
        self.n_inliers_last = n_final
        self.metrics.append(
            dict(frame=frame.frame_id, inliers=n_final,
                 motion_inliers=n_motion))
        if len(self.metrics) > 100_000:
            del self.metrics[:50_000]

    def _track_reference_keyframe(self, frame: FrameData) -> bool:
        """Descriptor match against the reference KF's map points (mutual,
        ratio 0.7, rotation-checked) + pose optimization from the last pose,
        then the local-map cascade at the recovered pose."""
        m = self.map
        cand = self.ref_kf
        if cand < 0 or not m.kf_valid[cand]:
            return False
        dev = self.device
        has = m.kf_feat_valid[cand] & (m.kf_mp[cand] >= 0)
        res = _match_rot.match_rot(
            frame.dev["desc"], torch.from_numpy(m.kf_desc[cand]).to(dev),
            frame.dev["valid"], torch.from_numpy(has).to(dev),
            frame.dev["angle"], torch.from_numpy(m.kf_angle[cand]).to(dev),
            matching.TH_LOW, 0.7)
        rv = res.valid.cpu().numpy()
        fidx = np.where(rv)[0]
        kidx = res.idx.cpu().numpy()[fidx]
        mps = m.kf_mp[cand, kidx]
        live = m.mp_valid[mps]
        fidx, mps = fidx[live], mps[live]
        if len(fidx) < 15:
            return False
        Tcw0 = (self.last_frame.Tcw
                if self.last_frame is not None and self.last_frame.Tcw is not None
                else m.kf_pose[cand])
        sf = self.cfg.extractor.scale_factor
        # padded to the keypoint capacity, as the reference pads it
        Np = self.cfg.extractor.max_keypoints
        N = len(fidx)
        pos_p = np.zeros((Np, 3), np.float32)
        pos_p[:N] = m.mp_pos[mps]
        obs_p = np.zeros((Np, 3), np.float32)
        obs_p[:N, :2] = frame.xy[fidx]
        obs_p[:N, 2] = frame.ur[fidx]
        sig_p = np.ones(Np, np.float32)
        sig_p[:N] = sf ** (2.0 * frame.octave[fidx].astype(np.float32))
        val_p = np.zeros(Np, bool)
        val_p[:N] = True

        def t(a):
            return torch.from_numpy(a).to(dev)

        opt = pose_opt.optimize_pose(
            t(np.asarray(Tcw0, np.float32)), self.cam, t(pos_p), t(obs_p),
            t(sig_p), t(val_p))
        if int(opt.n_inliers) < 10:
            return False
        sel, buf = self._gather_local_points()
        packed = self._run_fused(frame, opt.Tcw.cpu().numpy(), buf,
                                 self.cfg.tracking.motion_model_radius)
        Tcw2, n_inl, n_inl2, inl, kp_of_mp, frustum = self._unpack_fused(packed)
        if n_inl2 < self.cfg.tracking.min_inliers_local_map:
            return False
        self._commit_track(frame, sel, Tcw2, n_inl, n_inl2, inl, kp_of_mp,
                           frustum)
        return True

    # ------------------------------------------------------------------
    # Relocalization (Tracking::Relocalization)
    # ------------------------------------------------------------------
    def _relocalize(self, frame: FrameData) -> bool:
        """BoW candidates from the keyframe database (kernel Y); for each, a
        mutual match of the frame against the candidate's map points (kernel
        U, TH_LOW, ratio 0.75, no rotation check), EPnP RANSAC over 256
        samples drawn on the host (kernel Z), then a radius-10 projection
        pass from its pose and, when the count lands in the almost-enough
        band, a radius-3 pass with max_dist 64 (kernels O, C, Q, D, R)."""
        if self.kfdb is None:
            return False
        m = self.map
        dev = self.device
        qbow = self.kfdb.compute_bow(frame.dev["desc"], frame.dev["valid"])
        for cand in self.kfdb.detect_relocalization_candidates(qbow):
            has = m.kf_feat_valid[cand] & (m.kf_mp[cand] >= 0)
            res = _match_rot.match_rot(
                frame.dev["desc"], torch.from_numpy(m.kf_desc[cand]).to(dev),
                frame.dev["valid"], torch.from_numpy(has).to(dev), None, None,
                matching.TH_LOW, 0.75, check_rotation=False)
            rv = res.valid.cpu().numpy()
            if rv.sum() < 15:
                continue
            fidx = np.where(rv)[0]
            mps = m.kf_mp[cand, res.idx.cpu().numpy()[fidx]]
            live = m.mp_valid[mps]
            fidx, mps = fidx[live], mps[live]
            if len(fidx) < 15:
                continue
            N = len(fidx)
            sf = self.cfg.extractor.scale_factor
            samples = self._rng.integers(0, N, size=(256, pnp.SAMPLE_SIZE)).astype(np.int32)

            def t(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

            pr = _pnp_ransac.unpack(_pnp_ransac.pnp_ransac(
                self.cam, t(m.mp_pos[mps]), t(frame.xy[fidx].astype(np.float32)),
                t(sf ** (2.0 * frame.octave[fidx].astype(np.float32))),
                torch.ones(N, dtype=torch.bool, device=dev), t(samples),
            ).cpu().numpy(), N)
            if not pr.ok:
                continue
            self.ref_kf = cand
            sel, buf = self._gather_local_points()
            Tcw, n_inl, inl, kp_of_mp = self._project_pass(frame, pr.Tcw, buf, 10.0,
                                                           matching.TH_HIGH)
            required = self.cfg.tracking.min_inliers_after_reloc
            if 30 <= n_inl < required:
                Tcw, n_inl, inl, kp_of_mp = self._project_pass(frame, Tcw, buf, 3.0, 64)
            if n_inl < required:
                continue
            frame.Tcw = Tcw
            frame.mp[:] = -1
            rows = np.where(inl)[0]
            frame.mp[kp_of_mp[rows]] = sel[rows]
            self.n_inliers_last = n_inl
            return True
        return False

    def _project_pass(self, frame: FrameData, Tcw: np.ndarray, buf: dict,
                      radius: float, max_dist: int):
        """One track_against_points pass at ratio 0.9: (Tcw, n_inliers,
        inliers, kp_of_mp), from one copy to the host."""
        cfge = self.cfg.extractor
        packed = track_against_points(
            self.cam, torch.from_numpy(np.asarray(Tcw, np.float32)).to(self.device),
            buf["pos"], buf["desc"], buf["valid"], buf["normal"], buf["dmin"],
            buf["dmax"], frame.dev["xy"], frame.dev["desc"], frame.dev["octave"],
            frame.dev["valid"], frame.dev["ur"], frame.dev["depth"],
            self._f32(radius), self._f32(cfge.scale_factor), cfge.n_levels,
            max_dist, 0.9)
        T, _, n_final, _, inl, kp_of_mp, _ = self._decode(packed)
        return T, n_final, inl, kp_of_mp

    # ------------------------------------------------------------------
    # Keyframe policy (Tracking::NeedNewKeyFrame)
    # ------------------------------------------------------------------
    def _need_new_keyframe(self, frame: FrameData) -> bool:
        tcfg = self.cfg.tracking
        m = self.map
        since = frame.frame_id - self.last_kf_frame_id
        n_kfs = int(m.kf_valid.sum())
        ref_tracked = int((m.kf_mp[self.ref_kf] >= 0).sum())

        # close-point census: inserting is urgent when few close points are
        # tracked but many close candidates exist
        has_depth = self.cfg.sensor != "monocular"
        need_close = has_depth and (
            self.n_tracked_close < 100 and self.n_untracked_close > 70)
        th_ref = 0.75 if has_depth else 0.9
        if n_kfs < 2:
            th_ref = 0.4

        c1a = since >= tcfg.max_frames_between_kf
        # c1b: the mapper is idle and the gap since the last keyframe covers
        # its measured cost a keyframe, so admission settles at the rate
        # mapping sustains (the synchronous system's mapper is always idle
        # and costs 0); the deadline (c1a) and close-point starvation (c1c)
        # override the pace
        pace = min(self.mapping_kf_cost() * self.cfg.camera.fps,
                   0.5 * tcfg.max_frames_between_kf)
        c1b = since >= max(tcfg.min_frames_between_kf, 3, pace) and \
            not self.mapping_busy()
        c1c = has_depth and (
            self.n_inliers_last < ref_tracked * 0.25 or need_close)
        c2 = (self.n_inliers_last < ref_tracked * th_ref or need_close) \
            and self.n_inliers_last > 15
        if not ((c1a or c1b or c1c) and c2):
            return False
        # a keyframe that waits for a busy mapper interrupts its local BA:
        # only the depth-urgent case is worth that
        return bool(c1c) if self.mapping_busy() else True

    def _create_keyframe(self, frame: FrameData) -> int:
        with self.map.lock:
            return self._create_keyframe_locked(frame)

    def _create_keyframe_locked(self, frame: FrameData) -> int:
        m = self.map
        kf = m.add_keyframe(
            frame.Tcw.astype(np.float32), frame.xy, frame.desc, frame.octave,
            frame.angle, frame.valid, frame.frame_id, frame.timestamp,
            ur=frame.ur, depth=frame.depth,
        )
        if self.kfdb is not None and kf < len(self.kfdb.in_db):
            # a recycled slot must not surface the culled keyframe's BoW row
            self.kfdb.erase(kf)
        feats = np.where(frame.mp >= 0)[0]
        m.add_observations_batch(frame.mp[feats], kf, feats)
        if (frame.depth > 0).any():
            self._spawn_depth_points(frame, kf)
        m.update_connections(kf)
        m.version += 1
        self.ref_kf = kf
        self.last_kf_frame_id = frame.frame_id
        return kf

    def _spawn_depth_points(self, frame: FrameData, kf: int, max_new: int = 500):
        """RGB-D: spawn close points not yet matched (CreateNewKeyFrame), up
        to max_new, the closest first."""
        m = self.map
        th_depth = self.cfg.camera.th_depth * self._baseline
        cand = np.where(frame.valid & (frame.depth > 0) & (frame.mp < 0))[0]
        if len(cand) == 0:
            return
        order = cand[np.argsort(frame.depth[cand])]
        close = order[frame.depth[order] < th_depth]
        spawn = order[:max_new] if len(close) < 100 else close[:max_new]
        if len(spawn) == 0:
            return
        Twc = np.linalg.inv(frame.Tcw)
        fx, fy, cx, cy = self._fx, self._fy, self._cx, self._cy
        d = frame.depth[spawn][:, None]
        pc = np.concatenate(
            [(frame.xy[spawn, :1] - cx) / fx * d,
             (frame.xy[spawn, 1:2] - cy) / fy * d, d], axis=1
        ).astype(np.float32)
        pw = pc @ Twc[:3, :3].T + Twc[:3, 3]
        new_mps = m.add_map_points_batch(pw, kf)
        m.add_observations_batch(new_mps, kf, spawn)
        frame.mp[spawn] = new_mps
        m.init_point_attributes(new_mps, kf, spawn)
