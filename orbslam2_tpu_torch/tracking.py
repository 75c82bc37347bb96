"""Tracking: per-frame pose estimation state machine (port of
``orbslam2_tpu.tracking``, synchronous RGB-D path).

The same FSM as the reference (NO_IMAGES_YET / NOT_INITIALIZED / OK / LOST),
motion-model + local-map tracking and the keyframe decision. Per frame:

  extract (ops.orb: kernels A, B) -> fused cascade: up to four passes of
  project / frustum gates / gated Hamming top-2 (kernel C) / claim
  resolution / motion-only LM (kernel D) -> one packed result to the host.

Not in this slice (each raises NotImplementedError naming its ROADMAP
queue-1 slice): monocular and stereo initialisation (slice 6),
relocalization against a keyframe database and localization mode (slice 7),
pipelined tracking (slice 9). Without a keyframe database a LOST tracker
stays lost, as the reference's does with ``kfdb=None``.
"""

from __future__ import annotations

import enum
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from .config import SlamConfig
from .device import DEFAULT as DEFAULT_DEVICE, resolve as resolve_device
from .kernels import hamming as _hamming
from .map.state import MapState
from .models.camera import Camera, in_image, project, undistort_points
from .ops import matching, orb, pose_opt


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
# Tracking cascade: project local points -> gated match -> pose LM
# ---------------------------------------------------------------------------

def predict_projection(cam: Camera, Tcw_pred, mp_pos, mp_valid, mp_normal,
                       mp_dmin, mp_dmax, radius_mult: float,
                       scale_factor: float, n_levels: int):
    """Per local point: projection (P, 2), search radius (P,), predicted
    level (P,) int32, predicted u_right (P,), and the frustum mask
    (isInFrustum: depth in the scale band, in image, view angle < 60 deg)."""
    dev = mp_pos.device
    R = Tcw_pred[:3, :3]
    t = Tcw_pred[:3, 3]
    pc = mp_pos @ R.T + t
    z = pc[:, 2]
    proj = project(cam, pc)

    cam_center = -(R.T @ t)
    vec = mp_pos - cam_center
    dist = torch.linalg.norm(vec, dim=1)
    cos_view = (vec * mp_normal).sum(1) / dist.clamp_min(1e-9)
    in_frustum = (
        (z > 0.1)
        & in_image(cam, proj)
        & (dist >= 0.8 * mp_dmin)
        & (dist <= 1.2 * mp_dmax)
        & (cos_view > 0.5)
    )

    # PredictScale
    sf = torch.tensor(scale_factor, dtype=torch.float32, device=dev)
    ratio = (mp_dmax / dist.clamp_min(1e-9)).clamp_min(1e-6)
    pred_level = torch.ceil(torch.log(ratio) / torch.log(sf)).to(torch.int32) \
        .clamp(0, n_levels - 1)
    r_px = radius_mult * torch.pow(sf, pred_level.float())
    ur_pred = proj[:, 0] - cam.bf / z.clamp_min(1e-6)
    return proj, r_px, pred_level, ur_pred, in_frustum


def _project_match_opt(
    cam: Camera, Tcw_pred, mp_pos, mp_desc, mp_valid, mp_normal, mp_dmin,
    mp_dmax, kp_xy, kp_desc, kp_octave, kp_valid, kp_ur,
    radius_mult: float, scale_factor: float, n_levels: int, max_dist: int,
    nn_ratio: float, do_pose_opt: bool,
):
    """One SearchByProjection + PoseOptimization pass.

    Returns (PoseOptResult, MatchResult, keep (P,), in_frustum (P,)).
    """
    dev = mp_pos.device
    proj, r_px, pred_level, ur_pred, in_frustum = predict_projection(
        cam, Tcw_pred, mp_pos, mp_valid, mp_normal, mp_dmin, mp_dmax,
        radius_mult, scale_factor, n_levels)
    sf = torch.tensor(scale_factor, dtype=torch.float32, device=dev)

    # gated best / second-best per point (kernel C on the card)
    row_valid = mp_valid & in_frustum
    best_idx, best, second, second_idx = _hamming.hamming_top2_gated(
        mp_desc, proj, r_px, pred_level, ur_pred, row_valid,
        kp_desc, kp_xy, kp_octave, kp_valid, kp_ur)
    ok = (best <= max_dist) & row_valid
    ratio_ok = best.float() < nn_ratio * second.float()
    same_lvl = kp_octave[best_idx.long()] == kp_octave[second_idx.long()]
    ok = ok & (ratio_ok | ~same_lvl)
    res = matching.MatchResult(
        idx=torch.where(ok, best_idx, torch.full_like(best_idx, -1)),
        dist=torch.where(ok, best, torch.full_like(best, matching.INVALID)),
        valid=ok,
    )

    # several map points claiming one keypoint: keep the lowest distance,
    # then the lowest point index
    P = mp_pos.shape[0]
    N = kp_xy.shape[0]
    idx_l = res.idx.long()
    claim = torch.where(res.valid, idx_l, torch.full_like(idx_l, N - 1))
    kp_best = torch.full((N,), matching.INVALID, dtype=torch.int32, device=dev)
    kp_best = kp_best.scatter_reduce(
        0, claim, torch.where(res.valid, res.dist,
                              torch.full_like(res.dist, matching.INVALID)),
        reduce="amin")
    keep = res.valid & (res.dist <= kp_best[idx_l.clamp_min(0)])
    pidx = torch.arange(P, dtype=torch.int32, device=dev)
    claim = torch.where(keep, idx_l, torch.full_like(idx_l, N - 1))
    first_claim = torch.full((N,), P, dtype=torch.int32, device=dev)
    first_claim = first_claim.scatter_reduce(
        0, claim, torch.where(keep, pidx, torch.full_like(pidx, P)),
        reduce="amin")
    keep = keep & (first_claim[idx_l.clamp_min(0)] == pidx)

    idx = torch.where(keep, idx_l, torch.zeros_like(idx_l))
    obs = torch.cat([kp_xy[idx], torch.where(
        keep, kp_ur[idx], torch.full_like(kp_ur[idx], -1.0))[:, None]], 1)
    sigma2 = torch.pow(sf, 2.0 * kp_octave[idx].float())

    if do_pose_opt:
        opt = pose_opt.optimize_pose(Tcw_pred, cam, mp_pos, obs, sigma2, keep)
    else:
        opt = pose_opt.PoseOptResult(
            Tcw=Tcw_pred, inliers=keep, n_inliers=keep.sum().to(torch.int32),
            chi2=torch.zeros_like(sigma2))
    return opt, res, keep, in_frustum


def track_frame_fused(
    cam: Camera, Tcw_pred, mp_pos, mp_desc, mp_valid, mp_normal, mp_dmin,
    mp_dmax, kp_xy, kp_desc, kp_octave, kp_valid, kp_ur, kp_depth,
    th_depth: float, radius: float, scale_factor: float, n_levels: int,
    min_inliers_track: int,
) -> torch.Tensor:
    """The whole per-frame tracking cascade; returns the packed result
    [Tcw(16), n_motion, n_final, n_tracked_close, n_untracked_close,
    code per point (P)] as one (20 + P,) float32 tensor.

    Passes: motion model at ``radius`` (retried at 2x when it admits fewer
    than ``min_inliers_track`` inliers), a local-map pass at 4 px from the
    refined pose and a tight pass at 2 px, keeping the better of the last
    two. The per-point code is (kp_idx + 1) * 4 + inlier * 2 + frustum.
    """

    def run(Tcw, r):
        return _project_match_opt(
            cam, Tcw, mp_pos, mp_desc, mp_valid, mp_normal, mp_dmin, mp_dmax,
            kp_xy, kp_desc, kp_octave, kp_valid, kp_ur, r, scale_factor,
            n_levels, matching.TH_HIGH, 0.9, True)

    opt1, _, _, _ = run(Tcw_pred, radius)
    if int(opt1.n_inliers) < min_inliers_track:
        opt1, _, _, _ = run(Tcw_pred, 2.0 * radius)
    Tcw1, n_motion = opt1.Tcw, opt1.n_inliers

    opt2, res2, keep2, frustum2 = run(Tcw1, 4.0)
    opt3, res3, keep3, _ = run(opt2.Tcw, 2.0)
    use3 = opt3.n_inliers >= opt2.n_inliers
    Tcw = torch.where(use3, opt3.Tcw, opt2.Tcw)
    n_final = torch.where(use3, opt3.n_inliers, opt2.n_inliers)
    inl = torch.where(use3, opt3.inliers, opt2.inliers)
    neg = torch.full_like(res2.idx, -1)
    kp_of_mp = torch.where(use3, torch.where(keep3, res3.idx, neg),
                           torch.where(keep2, res2.idx, neg))

    # close-point census for the keyframe decision (nTrackedClose /
    # nNonTrackedClose), carried in the packed result
    N = kp_xy.shape[0]
    tracked_row = inl & (kp_of_mp >= 0)
    kp_tracked = torch.zeros(N + 1, dtype=torch.bool, device=mp_pos.device)
    kp_tracked[torch.where(tracked_row, kp_of_mp.long(),
                           torch.full_like(kp_of_mp.long(), N))] = True
    kp_tracked[N] = False
    kp_tracked = kp_tracked[:N]
    close = kp_valid & (kp_depth > 0) & (kp_depth < th_depth)
    n_tracked_close = (close & kp_tracked).sum()
    n_untracked_close = (close & ~kp_tracked).sum()

    code = (kp_of_mp + 1) * 4 + inl.to(torch.int32) * 2 \
        + (mp_valid & frustum2).to(torch.int32)
    return torch.cat([
        Tcw.reshape(-1),
        torch.stack([n_motion.float(), n_final.float(),
                     n_tracked_close.float(), n_untracked_close.float()]),
        code.float(),
    ])


def rgbd_virtual_right_u16(depth_q, depth_scale: float, kp_xy_raw,
                           kp_xy_undist, valid, bf: float, stride: int = 1):
    """Sample the millimetre-quantized depth map (integer tensor of the
    host-subsampled depth[::stride, ::stride]) at the rounded keypoints and
    derive the virtual right coordinate u_r = u - bf / d (-1 where no
    depth). Returns (ur, depth)."""
    H, W = depth_q.shape
    inv = 1.0 / float(stride)
    xi = torch.round(kp_xy_raw[:, 0] * inv).long().clamp(0, W - 1)
    yi = torch.round(kp_xy_raw[:, 1] * inv).long().clamp(0, H - 1)
    d = depth_q.reshape(-1)[yi * W + xi].float() * depth_scale
    ok = valid & (d > 0)
    neg = torch.full_like(d, -1.0)
    dep = torch.where(ok, d, neg)
    ur = torch.where(ok, kp_xy_undist[:, 0] - bf / d.clamp_min(1e-6), neg)
    return ur, dep


# ---------------------------------------------------------------------------
# Tracker
# ---------------------------------------------------------------------------

class Tracker:
    def __init__(self, cfg: SlamConfig, slam_map: MapState,
                 device=DEFAULT_DEVICE):
        self.cfg = cfg
        self.map = slam_map
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
        self.reset_requested = False
        self.pending_keyframes: List[int] = []
        self._neg_ones: Optional[torch.Tensor] = None
        self._local_cache_key = None

    def _f32(self, v) -> float:
        return float(np.float32(v))

    # ------------------------------------------------------------------
    def _make_frame(self, img: np.ndarray, timestamp: float,
                    depth_map: Optional[np.ndarray] = None,
                    right_img: Optional[np.ndarray] = None) -> FrameData:
        if right_img is not None:
            raise NotImplementedError(
                "stereo matching comes with ROADMAP queue 1, slice 6")
        feats = self.extractor(img)
        xy_dev = feats.xy
        if self.cam.has_distortion:
            xy_dev = undistort_points(self.cam, feats.xy)
        n = feats.xy.shape[0]
        if self._neg_ones is None or self._neg_ones.shape[0] != n:
            self._neg_ones = torch.full((n,), -1.0, device=self.device)
        dev = dict(
            xy=xy_dev, desc=feats.desc, octave=feats.octave,
            angle=feats.angle, valid=feats.valid,
            ur=self._neg_ones, depth=self._neg_ones,
        )
        if depth_map is not None:
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
            depth_q = torch.from_numpy(d_u16.astype(np.int32)).to(self.device)
            dev["ur"], dev["depth"] = rgbd_virtual_right_u16(
                depth_q, self._f32(1.0 / scale), feats.xy, xy_dev,
                feats.valid, self.cam.bf, stride=stride,
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

    def track_pipelined(self, *args, **kwargs):
        raise NotImplementedError(
            "pipelined tracking comes with ROADMAP queue 1, slice 9")

    def _track_core(self, frame: FrameData, t_start: float) -> Optional[np.ndarray]:
        new_kf = None
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
            if self._need_new_keyframe(frame):
                new_kf = self._create_keyframe(frame)
        else:
            self.state = TrackingState.LOST
            # lost right after initialization: the bootstrap map is junk,
            # request a full reset instead of relocalizing against it
            if int(self.map.kf_valid.sum()) <= 5:
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

    # ------------------------------------------------------------------
    # Initialization
    # ------------------------------------------------------------------
    def _initialize_monocular(self, frame: FrameData) -> bool:
        raise NotImplementedError(
            "monocular two-view initialization comes with ROADMAP queue 1, "
            "slice 6")

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
            pos=torch.from_numpy(m.mp_pos[sel]).to(dev),
            desc=torch.from_numpy(m.mp_desc[sel]).to(dev),
            valid=torch.from_numpy(valid).to(dev),
            normal=torch.from_numpy(m.mp_normal[sel]).to(dev),
            dmin=torch.from_numpy(m.mp_dmin[sel]).to(dev),
            dmax=torch.from_numpy(m.mp_dmax[sel]).to(dev),
        )
        self._local_cache_key = key
        self._local_cache = (sel, buf)
        return sel, buf

    def _run_fused(self, frame: FrameData, Tcw_pred: np.ndarray, buf: dict,
                   radius: float) -> torch.Tensor:
        cfge = self.cfg.extractor
        return track_frame_fused(
            self.cam, torch.from_numpy(np.asarray(Tcw_pred, np.float32)).to(self.device),
            buf["pos"], buf["desc"], buf["valid"], buf["normal"],
            buf["dmin"], buf["dmax"],
            frame.dev["xy"], frame.dev["desc"], frame.dev["octave"],
            frame.dev["valid"], frame.dev["ur"], frame.dev["depth"],
            self._f32(self.cfg.camera.th_depth * self._baseline),
            self._f32(radius), self._f32(cfge.scale_factor), cfge.n_levels,
            self.cfg.tracking.min_inliers_track,
        )

    def _unpack_fused(self, packed):
        """Split the packed cascade result (the frame's single D2H copy)."""
        p = packed.cpu().numpy()
        Tcw = p[:16].reshape(4, 4).astype(np.float32)
        n_motion = int(p[16])
        n_final = int(p[17])
        self.n_tracked_close = int(p[18])
        self.n_untracked_close = int(p[19])
        code = p[20:].astype(np.int32)
        kp_of_mp = (code >> 2) - 1
        inl = (code & 2) > 0
        frustum = (code & 1) > 0
        return Tcw, n_motion, n_final, inl, kp_of_mp, frustum

    def _dispatch_track(self, frame: FrameData):
        """Run the fused cascade for one frame from the motion model
        (falling back to the last pose at twice the radius)."""
        m = self.map
        sel, buf = self._gather_local_points()
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

    def _track_frame(self, frame: FrameData) -> bool:
        sel, packed = self._dispatch_track(frame)
        return self._finish_track(frame, sel, packed)

    def _finish_track(self, frame: FrameData, sel, packed) -> bool:
        Tcw2, n_inl, n_inl2, inl, kp_of_mp, frustum = self._unpack_fused(packed)
        if (n_inl < self.cfg.tracking.min_inliers_track
                or n_inl2 < self.cfg.tracking.min_inliers_local_map):
            # fall back to matching against the reference keyframe
            # (Tracking::TrackReferenceKeyFrame)
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
        res = matching.match_descriptors(
            frame.dev["desc"], torch.from_numpy(m.kf_desc[cand]).to(dev),
            frame.dev["valid"], torch.from_numpy(has).to(dev),
            max_dist=matching.TH_LOW, nn_ratio=0.7, mutual=True,
            angles_a=frame.dev["angle"],
            angles_b=torch.from_numpy(m.kf_angle[cand]).to(dev),
            check_rotation=True,
        )
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

    def _relocalize(self, frame: FrameData) -> bool:
        # no keyframe database before ROADMAP queue 1, slice 7: a lost
        # tracker stays lost, as the reference's does without one
        return False

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

        # the synchronous system maps every keyframe before the next frame,
        # so the mapper is always idle here (the reference's c1b without
        # its busy and pacing terms)
        c1a = since >= tcfg.max_frames_between_kf
        c1b = since >= max(tcfg.min_frames_between_kf, 3)
        c1c = has_depth and (
            self.n_inliers_last < ref_tracked * 0.25 or need_close)
        c2 = (self.n_inliers_last < ref_tracked * th_ref or need_close) \
            and self.n_inliers_last > 15
        return bool((c1a or c1b or c1c) and c2)

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
