"""The map as fixed-capacity structure-of-arrays state (single-writer).

Port of ``orbslam2_tpu.map.state``: the host numpy arrays and their
bookkeeping are the reference's; the device keyframe mirror holds torch
tensors on the map's ``device``.

Replaces the reference's L1 pointer graph — Map / KeyFrame / MapPoint /
observation maps / covisibility graph, all raw pointers + per-object mutexes
(†src/{Map,KeyFrame,MapPoint}.cc, SURVEY §2.1 rows 8-10, §2.3) — with numpy
arrays of static capacity plus `alive` masks. There is exactly one writer
(the mapping side); tracking consumes immutable device snapshots, which is
what removes the reference's entire mutex inventory (SURVEY §5.2).

Host numpy is deliberate for the graph bookkeeping (irregular, tiny);
compute-heavy consumers (matching, BA) gather compact windows and ship them
to device.

Layout:
  keyframes:  pose, per-feature arrays (xy, desc, octave, angle, uR, depth),
              feature->map-point index table (the observations, KF side)
  map points: position, distinctive descriptor, normal, scale band,
              observation list (point side: (kf, feat) pairs), statistics
  graph:      covisibility top-k neighbors + weights, spanning tree parent,
              loop edges
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import SlamConfig
from ..device import DEFAULT as DEFAULT_DEVICE, resolve as resolve_device


class KfDeviceMirror:
    """Device-resident copies of the per-keyframe FEATURE arrays.

    A keyframe's features (xy, desc, octave, ur, depth, feat_valid) are
    written once at insertion and never change, so they can live on device
    permanently: consumers (triangulation, fuse, BoW, loop matching) index
    the mirror with keyframe ids instead of re-uploading host gathers on
    every call.

    Mutable per-KF state (pose, kf_mp bindings, validity) is NOT mirrored —
    it is small and passed host->device per call, which also sidesteps any
    coherence protocol. The mirror is invalidated wholesale on capacity
    growth and map clear; `ensure()` rebuilds it from host state.
    """

    FIELDS = ("kf_desc", "kf_xy", "kf_octave", "kf_ur", "kf_depth",
              "kf_feat_valid")

    def __init__(self, device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.arrays: Optional[dict] = None
        self._capacity = -1

    def invalidate(self):
        self.arrays = None
        self._capacity = -1

    def ensure(self, m: "MapState") -> dict:
        """Build (or rebuild after growth) from host arrays; returns the
        device dict. Call under the map lock."""
        if self.arrays is not None and self._capacity == m.kf_valid.shape[0]:
            return self.arrays
        # a snapshot (copy=True), as the reference's device_put is: later
        # host writes reach the mirror only through upload_kf
        self.arrays = {f: torch.from_numpy(getattr(m, f)).to(self.device,
                                                             copy=True)
                       for f in self.FIELDS}
        self._capacity = m.kf_valid.shape[0]
        return self.arrays

    def upload_kf(self, m: "MapState", k: int):
        """Refresh one keyframe row after insertion (no-op until a consumer
        has built the mirror). One H2D copy per field."""
        if self.arrays is None:
            return
        for f in self.FIELDS:
            self.arrays[f][k] = torch.from_numpy(
                np.ascontiguousarray(getattr(m, f)[k])).to(self.device)


@dataclass
class MapState:
    cfg: SlamConfig

    # --- keyframes -----------------------------------------------------
    kf_pose: np.ndarray          # (K, 4, 4) f32, Tcw
    kf_valid: np.ndarray         # (K,) bool
    kf_seq: np.ndarray           # (K,) i64 monotone creation order (slot ids
    #                              are RECYCLED, so id order != temporal order)
    kf_frame_id: np.ndarray      # (K,) i64 source frame id
    kf_timestamp: np.ndarray     # (K,) f64
    kf_xy: np.ndarray            # (K, N, 2) f32 undistorted level-0 coords
    kf_desc: np.ndarray          # (K, N, 32) u8
    kf_octave: np.ndarray        # (K, N) i32
    kf_angle: np.ndarray         # (K, N) f32
    kf_ur: np.ndarray            # (K, N) f32 right-u (-1 mono)
    kf_depth: np.ndarray         # (K, N) f32 stereo/RGBD depth (-1 unknown)
    kf_feat_valid: np.ndarray    # (K, N) bool
    kf_mp: np.ndarray            # (K, N) i32 map-point id per feature (-1)

    # --- map points ----------------------------------------------------
    mp_pos: np.ndarray           # (M, 3) f32 world position
    mp_valid: np.ndarray         # (M,) bool
    mp_desc: np.ndarray          # (M, 32) u8 distinctive descriptor
    mp_normal: np.ndarray        # (M, 3) f32 mean viewing direction
    mp_dmin: np.ndarray          # (M,) f32 scale-invariance band
    mp_dmax: np.ndarray          # (M,) f32
    mp_ref_kf: np.ndarray        # (M,) i32 reference keyframe
    mp_first_kf: np.ndarray      # (M,) i32 creation keyframe (culling window)
    mp_obs_kf: np.ndarray        # (M, Omax) i32 observing keyframe (-1)
    mp_obs_feat: np.ndarray      # (M, Omax) i32 feature index in that KF
    mp_n_obs: np.ndarray         # (M,) i32
    mp_visible: np.ndarray       # (M,) i32 tracking visibility count
    mp_found: np.ndarray         # (M,) i32 tracking found count

    # --- graph ---------------------------------------------------------
    covis_idx: np.ndarray        # (K, C) i32 neighbor kf ids (-1)
    covis_w: np.ndarray          # (K, C) i32 shared-point weights
    span_parent: np.ndarray      # (K,) i32 spanning-tree parent (-1 root)
    loop_edges: List[Tuple[int, int]] = field(default_factory=list)
    free_mp: List[int] = field(default_factory=list)  # allocatable slots
    free_mp_pending: List[int] = field(default_factory=list)  # grace period
    free_kf: List[int] = field(default_factory=list)  # recycled KF slots
    free_kf_pending: List[int] = field(default_factory=list)
    obs_drops: int = 0  # observations dropped on a full per-point table
    # snapshots of slot ids that outlive a keyframe cycle, one token each
    # (a global BA between its gather and its write-back): while any is
    # out, recycle_free_slots keeps freed slots pending
    recycle_holds: List[object] = field(default_factory=list)

    # Coarse mutation lock: tracking creates keyframes while the async
    # mapping worker mutates the same tables; both paths run at keyframe
    # rate, so one lock costs nothing and removes element-level races.
    # Reads (tracking gathers) stay lock-free (stale-but-consistent-enough,
    # same semantics the reference's fine-grained locks provide).
    # RLock: loop correction holds it while synchronous GBA re-acquires it
    # for its gather/write-back sections
    lock: threading.RLock = field(default_factory=threading.RLock)

    n_kf: int = 0                # monotone high-water marks
    n_mp: int = 0
    next_kf_id: int = 0
    version: int = 0             # bumped on structural writes (gather caches)
    # Bumped (under the lock) whenever poses/points are rewritten wholesale
    # by a loop correction or a GBA write-back. Mapper work that gathered
    # BEFORE the bump and would commit AFTER it (the gather -> off-lock
    # device solve -> commit discipline) must DISCARD its result: a local
    # BA / triangulation computed against pre-correction geometry would
    # clobber the correction (the reference prevents this with the
    # LocalMapping::RequestStop handshake around †CorrectLoop).
    correction_epoch: int = 0
    dev_kf: KfDeviceMirror = field(default_factory=KfDeviceMirror)
    device: str = DEFAULT_DEVICE

    # ------------------------------------------------------------------
    @staticmethod
    def allocate(cfg: SlamConfig, device=DEFAULT_DEVICE) -> "MapState":
        K = cfg.capacity.max_keyframes
        M = cfg.capacity.max_map_points
        N = cfg.extractor.max_keypoints
        O = cfg.capacity.max_obs_per_point
        C = cfg.capacity.covisibility_top_k
        return MapState(
            cfg=cfg,
            kf_pose=np.tile(np.eye(4, dtype=np.float32), (K, 1, 1)),
            kf_valid=np.zeros(K, bool),
            kf_seq=np.zeros(K, np.int64),
            kf_frame_id=np.zeros(K, np.int64),
            kf_timestamp=np.zeros(K, np.float64),
            kf_xy=np.zeros((K, N, 2), np.float32),
            kf_desc=np.zeros((K, N, 32), np.uint8),
            kf_octave=np.zeros((K, N), np.int32),
            kf_angle=np.zeros((K, N), np.float32),
            kf_ur=np.full((K, N), -1.0, np.float32),
            kf_depth=np.full((K, N), -1.0, np.float32),
            kf_feat_valid=np.zeros((K, N), bool),
            kf_mp=np.full((K, N), -1, np.int32),
            mp_pos=np.zeros((M, 3), np.float32),
            mp_valid=np.zeros(M, bool),
            mp_desc=np.zeros((M, 32), np.uint8),
            mp_normal=np.zeros((M, 3), np.float32),
            mp_dmin=np.zeros(M, np.float32),
            mp_dmax=np.full(M, np.inf, np.float32),
            mp_ref_kf=np.full(M, -1, np.int32),
            mp_first_kf=np.full(M, -1, np.int32),
            mp_obs_kf=np.full((M, O), -1, np.int32),
            mp_obs_feat=np.full((M, O), -1, np.int32),
            mp_n_obs=np.zeros(M, np.int32),
            mp_visible=np.zeros(M, np.int32),
            mp_found=np.zeros(M, np.int32),
            covis_idx=np.full((K, C), -1, np.int32),
            covis_w=np.zeros((K, C), np.int32),
            span_parent=np.full(K, -1, np.int32),
            dev_kf=KfDeviceMirror(device),
            device=str(device),
        )

    # ------------------------------------------------------------------
    # Keyframes
    # ------------------------------------------------------------------
    def add_keyframe(
        self,
        pose: np.ndarray,
        xy: np.ndarray,
        desc: np.ndarray,
        octave: np.ndarray,
        angle: np.ndarray,
        feat_valid: np.ndarray,
        frame_id: int,
        timestamp: float,
        ur: Optional[np.ndarray] = None,
        depth: Optional[np.ndarray] = None,
    ) -> int:
        """Insert a keyframe; returns its id (recycling culled slots, then
        growing the arrays when the live set genuinely exceeds capacity)."""
        if self.free_kf:
            k = self.free_kf.pop()
            # reset recycled slot state the fast path below doesn't cover
            self.covis_idx[k] = -1
            self.covis_w[k] = 0
            self.span_parent[k] = -1
            self.kf_ur[k] = -1.0
            self.kf_depth[k] = -1.0
        else:
            k = self.n_kf
            if k >= self.kf_valid.shape[0]:
                self.grow(new_kf=2 * self.kf_valid.shape[0])
            self.n_kf = k + 1
        self.kf_seq[k] = self.next_kf_id
        self.next_kf_id += 1
        self.kf_pose[k] = pose
        self.kf_valid[k] = True
        self.kf_frame_id[k] = frame_id
        self.kf_timestamp[k] = timestamp
        self.kf_xy[k] = xy
        self.kf_desc[k] = desc
        self.kf_octave[k] = octave
        self.kf_angle[k] = angle
        self.kf_feat_valid[k] = feat_valid
        self.kf_mp[k] = -1
        if ur is not None:
            self.kf_ur[k] = ur
        if depth is not None:
            self.kf_depth[k] = depth
        self.dev_kf.upload_kf(self, k)
        return k

    # ------------------------------------------------------------------
    # Map points
    # ------------------------------------------------------------------
    def add_map_point(self, pos: np.ndarray, ref_kf: int) -> int:
        """Allocate a point slot, recycling culled slots first (long runs
        churn points heavily; a monotone high-water mark would exhaust the
        capacity even though the live set stays small)."""
        if self.free_mp:
            m = self.free_mp.pop()
        else:
            m = self.n_mp
            if m >= self.mp_valid.shape[0]:
                self.grow(new_mp=2 * self.mp_valid.shape[0])
            self.n_mp = m + 1
        self.mp_pos[m] = pos
        self.mp_valid[m] = True
        self.mp_ref_kf[m] = ref_kf
        self.mp_first_kf[m] = ref_kf
        self.mp_n_obs[m] = 0
        self.mp_visible[m] = 1
        self.mp_found[m] = 1
        self.mp_obs_kf[m] = -1
        self.mp_obs_feat[m] = -1
        self.mp_normal[m] = 0.0
        self.mp_dmin[m] = 0.0
        self.mp_dmax[m] = np.inf
        return m

    def add_map_points_batch(self, pos: np.ndarray, ref_kf: int) -> np.ndarray:
        """Vectorized add_map_point for n fresh points; returns their ids.

        Same recycling-then-grow policy; the per-slot field init is one
        fancy-indexed write per array instead of n Python-loop iterations
        (keyframe creation spawns up to 500 depth points at once — the loop
        was a measurable host-side stall on the tracking thread).
        """
        n = len(pos)
        if n == 0:
            return np.empty(0, np.int64)
        ids = np.empty(n, np.int64)
        n_recycled = min(len(self.free_mp), n)
        for i in range(n_recycled):
            ids[i] = self.free_mp.pop()
        n_new = n - n_recycled
        if n_new > 0:
            while self.n_mp + n_new > self.mp_valid.shape[0]:
                self.grow(new_mp=2 * self.mp_valid.shape[0])
            ids[n_recycled:] = np.arange(self.n_mp, self.n_mp + n_new)
            self.n_mp += n_new
        self.mp_pos[ids] = pos
        self.mp_valid[ids] = True
        self.mp_ref_kf[ids] = ref_kf
        self.mp_first_kf[ids] = ref_kf
        self.mp_n_obs[ids] = 0
        self.mp_visible[ids] = 1
        self.mp_found[ids] = 1
        self.mp_obs_kf[ids] = -1
        self.mp_obs_feat[ids] = -1
        self.mp_normal[ids] = 0.0
        self.mp_dmin[ids] = 0.0
        self.mp_dmax[ids] = np.inf
        return ids

    OBS_SLOT_LIMIT = 512  # hard ceiling for obs-table growth

    def _grow_obs_table(self) -> bool:
        """Double the per-point observation capacity (columns).

        The reference's observation map is unbounded (†MapPoint::mObservations
        std::map); a fixed column count is an artifact of the array layout, so when it
        fills we grow it rather than drop observations (dropping was a
        covisibility/culling recall cliff at exactly the map sizes where
        strong, long-lived points exceed 32 observers). Consumers that jit on
        the column width (point-attribute refresh) simply trace one more
        signature at the new width — a one-off, keyframe-rate cost.
        """
        O = self.mp_obs_kf.shape[1]
        new_o = min(O * 2, self.OBS_SLOT_LIMIT)
        if new_o == O:
            return False
        pad_kf = np.full((self.mp_obs_kf.shape[0], new_o - O), -1, np.int32)
        self.mp_obs_kf = np.concatenate([self.mp_obs_kf, pad_kf], axis=1)
        self.mp_obs_feat = np.concatenate(
            [self.mp_obs_feat, pad_kf.copy()], axis=1
        )
        print(f"[map] obs table grown: {O} -> {new_o} slots/point")
        return True

    def add_observations_batch(self, mps: np.ndarray, kf: int,
                               feats: np.ndarray):
        """Vectorized add_observation: bind each (mp, feat) pair to `kf`.

        `mps` must be unique (one observation per map point per call — true
        for keyframe creation, where each feature matches a distinct point).
        """
        mps = np.asarray(mps)
        feats = np.asarray(feats)
        if len(mps) == 0:
            return
        fresh = self.kf_mp[kf, feats] != mps
        mps, feats = mps[fresh], feats[fresh]
        if len(mps) == 0:
            return
        while True:
            slots = self.mp_obs_kf[mps]                 # (n, O)
            has_free = (slots < 0).any(axis=1)
            if has_free.all() or not self._grow_obs_table():
                break
        s = np.argmax(slots < 0, axis=1)                # first free slot
        n_drop = int((~has_free).sum())
        if n_drop:  # only at the hard OBS_SLOT_LIMIT ceiling
            self.obs_drops += n_drop
            print(f"[map] obs table full: dropped {self.obs_drops} "
                  f"observations so far (slots={slots.shape[1]})")
        mps, feats, s = mps[has_free], feats[has_free], s[has_free]
        self.mp_obs_kf[mps, s] = kf
        self.mp_obs_feat[mps, s] = feats
        self.mp_n_obs[mps] += 1
        self.kf_mp[kf, feats] = mps

    def init_point_attributes(self, mps: np.ndarray, kf: int,
                              feats: np.ndarray):
        """Fast-path attribute init for FRESH points with exactly one
        observation (kf, feat): the distinctive descriptor is the feature's
        own descriptor, the normal is the viewing ray, and the scale band
        comes from the feature's octave (†MapPoint ctor +
        UpdateNormalAndDepth with a single observation). Avoids the full
        median-Hamming update_point_attributes pass on the tracking thread.
        """
        mps = np.asarray(mps)
        feats = np.asarray(feats)
        if len(mps) == 0:
            return
        sf = self.cfg.extractor.scale_factor
        n_levels = self.cfg.extractor.n_levels
        self.mp_desc[mps] = self.kf_desc[kf, feats]
        T = self.kf_pose[kf]
        center = -T[:3, :3].T @ T[:3, 3]
        vec = self.mp_pos[mps] - center
        dist = np.linalg.norm(vec, axis=1)
        self.mp_normal[mps] = vec / np.maximum(dist, 1e-9)[:, None]
        level = self.kf_octave[kf, feats].astype(np.float32)
        dmax = dist * (sf ** level)
        self.mp_dmax[mps] = dmax
        self.mp_dmin[mps] = dmax / (sf ** (n_levels - 1))

    def add_observation(self, mp: int, kf: int, feat: int):
        """Bind map point <-> keyframe feature (both directions)."""
        if self.kf_mp[kf, feat] == mp:
            return
        slots = self.mp_obs_kf[mp]
        free = np.where(slots < 0)[0]
        if len(free) == 0 and self._grow_obs_table():
            slots = self.mp_obs_kf[mp]
            free = np.where(slots < 0)[0]
        if len(free) == 0:  # only at the hard OBS_SLOT_LIMIT ceiling
            self.obs_drops += 1
            if self.obs_drops & (self.obs_drops - 1) == 0:  # 1,2,4,8,...
                print(f"[map] obs table full: dropped {self.obs_drops} "
                      f"observations so far (slots={len(slots)})")
            return
        s = free[0]
        self.mp_obs_kf[mp, s] = kf
        self.mp_obs_feat[mp, s] = feat
        self.mp_n_obs[mp] += 1
        self.kf_mp[kf, feat] = mp

    def erase_observation(self, mp: int, kf: int):
        sl = np.where(self.mp_obs_kf[mp] == kf)[0]
        for s in sl:
            feat = self.mp_obs_feat[mp, s]
            if feat >= 0 and self.kf_mp[kf, feat] == mp:
                self.kf_mp[kf, feat] = -1
            self.mp_obs_kf[mp, s] = -1
            self.mp_obs_feat[mp, s] = -1
            self.mp_n_obs[mp] -= 1
        # reference kills points that fall to <= 2 observations when erased
        if self.mp_n_obs[mp] <= 2 and self.mp_valid[mp]:
            pass  # caller (culling) decides; we only maintain counts here

    def remove_map_point(self, mp: int):
        """SetBadFlag: unlink from all keyframes and invalidate."""
        for s in range(self.mp_obs_kf.shape[1]):
            kf = self.mp_obs_kf[mp, s]
            if kf >= 0:
                feat = self.mp_obs_feat[mp, s]
                if feat >= 0 and self.kf_mp[kf, feat] == mp:
                    self.kf_mp[kf, feat] = -1
            self.mp_obs_kf[mp, s] = -1
            self.mp_obs_feat[mp, s] = -1
        self.mp_n_obs[mp] = 0
        self.mp_valid[mp] = False
        self.free_mp_pending.append(int(mp))

    def replace_map_point(self, old: int, new: int):
        """MapPoint::Replace — rebind all observations of `old` to `new`."""
        if old == new:
            return
        for s in range(self.mp_obs_kf.shape[1]):
            kf = self.mp_obs_kf[old, s]
            feat = self.mp_obs_feat[old, s]
            if kf < 0:
                continue
            if self.kf_mp[kf, feat] == old:
                self.kf_mp[kf, feat] = -1
            if not (self.mp_obs_kf[new] == kf).any():
                self.add_observation(new, kf, feat)
            else:
                if self.kf_mp[kf, feat] == -1:
                    pass  # new already observed in this KF at another feature
        self.mp_found[new] += self.mp_found[old]
        self.mp_visible[new] += self.mp_visible[old]
        self.mp_obs_kf[old] = -1
        self.mp_obs_feat[old] = -1
        self.mp_n_obs[old] = 0
        self.mp_valid[old] = False
        self.free_mp_pending.append(int(old))

    # ------------------------------------------------------------------
    # Derived per-point attributes (†MapPoint::{ComputeDistinctiveDescriptors,
    # UpdateNormalAndDepth})
    # ------------------------------------------------------------------
    def update_point_attributes(self, mps: np.ndarray):
        """Recompute distinctive descriptor, normal, and depth band for the
        given point ids.

        Large batches run on the device against the keyframe mirror
        (kernel N, kernels/point_attrs.py): the host pass below is
        O(P*O^2) numpy. Small batches stay on host, as in the reference."""
        mps = np.atleast_1d(np.asarray(mps))
        mps = mps[self.mp_valid[mps]]
        if len(mps) == 0:
            return
        if len(mps) >= 128 and self.dev_kf.arrays is not None:
            return self._update_point_attributes_device(mps)
        sf = self.cfg.extractor.scale_factor
        n_levels = self.cfg.extractor.n_levels
        P = len(mps)
        O = self.mp_obs_kf.shape[1]
        obs_kf = self.mp_obs_kf[mps]                  # (P, O)
        obs_ft = self.mp_obs_feat[mps]
        sel = obs_kf >= 0
        if not sel.any():
            return
        kfs = np.maximum(obs_kf, 0)
        fts = np.maximum(obs_ft, 0)

        # --- distinctive descriptor: min median pairwise Hamming
        descs = self.kf_desc[kfs, fts]                # (P, O, 32)
        bits = np.unpackbits(descs.reshape(P * O, 32), axis=1).reshape(
            P, O, 256
        ).astype(np.float32)
        # Hamming via matmul: d = |a| + |b| - 2 a.b (avoids the (P,O,O,256)
        # broadcast blowup)
        G = np.matmul(bits, bits.transpose(0, 2, 1))  # (P, O, O)
        s = bits.sum(-1)
        dm = (s[:, :, None] + s[:, None, :] - 2.0 * G).astype(np.int32)
        big = 10000
        dm = np.where(sel[:, :, None] & sel[:, None, :], dm, big)
        dm_sorted = np.sort(dm, axis=2)
        n_obs = sel.sum(1)                            # (P,)
        med_idx = np.maximum((n_obs - 1) // 2, 0)
        med = np.take_along_axis(
            dm_sorted, med_idx[:, None, None].repeat(O, 1), axis=2
        )[:, :, 0]                                    # (P, O)
        med = np.where(sel, med, big)
        best = np.argmin(med, axis=1)
        self.mp_desc[mps] = descs[np.arange(P), best]

        # --- mean viewing normal
        R = self.kf_pose[kfs][..., :3, :3]            # (P, O, 3, 3)
        t = self.kf_pose[kfs][..., :3, 3]
        centers = -np.einsum("pokj,pok->poj", R, t)   # R^T t with R transposed
        vec = self.mp_pos[mps][:, None, :] - centers  # (P, O, 3)
        vn = vec / np.maximum(np.linalg.norm(vec, axis=2, keepdims=True), 1e-9)
        n = np.where(sel[:, :, None], vn, 0.0).sum(1) / np.maximum(
            n_obs[:, None], 1
        )
        self.mp_normal[mps] = n / np.maximum(
            np.linalg.norm(n, axis=1, keepdims=True), 1e-9
        )

        # --- scale band from the reference-KF observation
        rk = self.mp_ref_kf[mps]                      # (P,)
        is_ref = sel & (obs_kf == rk[:, None])
        has_ref = is_ref.any(1)
        j = np.where(has_ref, np.argmax(is_ref, axis=1), np.argmax(sel, axis=1))
        self.mp_ref_kf[mps] = obs_kf[np.arange(P), j]
        dist = np.linalg.norm(vec[np.arange(P), j], axis=1)
        level = self.kf_octave[kfs[np.arange(P), j], fts[np.arange(P), j]]
        # †MapPoint::UpdateNormalAndDepth: mfMaxDistance = dist * sf^level
        # (UNscaled — the 0.8/1.2 margins live only in the frustum gate and
        # PredictScale consumes the raw dmax; baking 1.2 in here biased the
        # predicted pyramid level by exactly +1 and widened search radii)
        dmax = dist * (sf ** level.astype(np.float32))
        self.mp_dmax[mps] = dmax
        self.mp_dmin[mps] = dmax / (sf ** (n_levels - 1))

    def _update_point_attributes_device(self, mps: np.ndarray):
        """Attribute refresh on device (kernel N on the card; the same math
        as the host pass above),
        with the batch padded to the reference's buckets and the observation
        axis compacted to the smallest power-of-two bucket covering this
        batch's max observation count."""
        from ..kernels import point_attrs

        sf = self.cfg.extractor.scale_factor
        n_levels = self.cfg.extractor.n_levels
        P = len(mps)
        Pb = 128  # x4 steps: each bucket is a distinct program (see gather)
        while Pb < P:
            Pb *= 4
        pad = Pb - P
        raw_kf = self.mp_obs_kf[mps]
        raw_ft = self.mp_obs_feat[mps]
        has = raw_kf >= 0
        max_obs = int(has.sum(1).max(initial=1))
        Ob = 8
        while Ob < max_obs and Ob < raw_kf.shape[1]:
            Ob *= 2
        Ob = min(Ob, raw_kf.shape[1])
        # compact live slots to the front, keep the first Ob (lossless:
        # Ob >= max per-row count)
        order = np.argsort(~has, axis=1, kind="stable")[:, :Ob]
        rows = np.arange(P)[:, None]
        obs_kf = np.full((Pb, Ob), -1, np.int16)
        obs_ft = np.full((Pb, Ob), -1, np.int16)
        np.clip(raw_kf[rows, order], -1, 32767, out=obs_kf[:P], casting="unsafe")
        np.clip(raw_ft[rows, order], -1, 32767, out=obs_ft[:P], casting="unsafe")
        pos = np.concatenate([self.mp_pos[mps],
                              np.zeros((pad, 3), np.float32)])
        ref = np.concatenate([self.mp_ref_kf[mps],
                              np.full(pad, -1, np.int32)])
        mir = self.dev_kf.ensure(self)
        dev = self.dev_kf.device
        packed = point_attrs.point_attributes(
            mir["kf_desc"], mir["kf_octave"],
            torch.from_numpy(self.kf_pose).to(dev),
            torch.from_numpy(obs_kf).to(dev), torch.from_numpy(obs_ft).to(dev),
            torch.from_numpy(pos).to(dev), torch.from_numpy(ref).to(dev),
            float(np.float32(sf)), float(np.float32(n_levels - 1)),
        )
        out = packed.cpu().numpy()[:P]
        # rows that lost every observation while queued keep old attributes
        live = (obs_kf[:P] >= 0).any(1)
        rows = mps[live]
        out = out[live]
        self.mp_desc[rows] = np.clip(np.rint(out[:, :32]), 0, 255).astype(
            np.uint8)
        self.mp_normal[rows] = out[:, 32:35]
        self.mp_dmin[rows] = out[:, 35]
        self.mp_dmax[rows] = out[:, 36]
        self.mp_ref_kf[rows] = out[:, 37].astype(np.int32)

    # ------------------------------------------------------------------
    # Covisibility (†KeyFrame::UpdateConnections)
    # ------------------------------------------------------------------
    def update_connections(self, kf: int):
        """Recompute covisibility of `kf` vs all others from shared points;
        weight >= threshold keeps the edge (else keep single best); assigns
        spanning-tree parent = highest-weight neighbor on first connect."""
        th = self.cfg.mapping.covisibility_threshold
        C = self.covis_idx.shape[1]
        mps = self.kf_mp[kf]
        mps = mps[mps >= 0]
        if len(mps) == 0:
            return
        obs_kfs = self.mp_obs_kf[mps]  # (n, O)
        flat = obs_kfs[obs_kfs >= 0]
        flat = flat[flat != kf]
        if len(flat) == 0:
            return
        counts = np.bincount(flat, minlength=self.n_kf)
        order = np.argsort(-counts)
        weights = counts[order]
        keep = weights >= th
        if not keep.any():
            keep[0] = weights[0] > 0  # single best fallback
        sel = order[keep][:C]
        w = counts[sel]
        self.covis_idx[kf] = -1
        self.covis_w[kf] = 0
        self.covis_idx[kf, : len(sel)] = sel
        self.covis_w[kf, : len(sel)] = w
        # mirror into neighbors' lists
        for j, wj in zip(sel, w):
            self._covis_insert(int(j), kf, int(wj))
        if self.span_parent[kf] < 0 and kf != 0 and len(sel) > 0:
            self.span_parent[kf] = int(sel[0])

    def _covis_insert(self, kf: int, nb: int, w: int):
        idx = self.covis_idx[kf]
        ws = self.covis_w[kf]
        pos = np.where(idx == nb)[0]
        if len(pos):
            ws[pos[0]] = w
        else:
            free = np.where(idx < 0)[0]
            if len(free):
                idx[free[0]] = nb
                ws[free[0]] = w
            else:
                worst = int(np.argmin(ws))
                if ws[worst] < w:
                    idx[worst] = nb
                    ws[worst] = w
        # keep sorted by weight descending
        order = np.argsort(-ws)
        self.covis_idx[kf] = idx[order]
        self.covis_w[kf] = ws[order]

    def covisible_keyframes(self, kf: int, n: int = 0) -> np.ndarray:
        """Best-covisibility neighbors (†GetBestCovisibilityKeyFrames)."""
        idx = self.covis_idx[kf]
        sel = idx[idx >= 0]
        return sel[:n] if n else sel

    def remove_keyframe(self, kf: int):
        """KeyFrame::SetBadFlag — detach observations and graph edges.

        Children are re-parented with the reference's iterative
        best-covisible-parent search: the candidate-parent set starts as
        {removed node's parent} and grows with each re-parented child, and
        at every step the (child, candidate) pair with the highest
        covisibility weight is connected; children with no covisible
        candidate fall back to the removed node's parent."""
        touched = self.kf_mp[kf][self.kf_mp[kf] >= 0]
        for mp in touched:
            self.erase_observation(int(mp), kf)
        self.kf_valid[kf] = False
        self.kf_feat_valid[kf] = False
        # drop from neighbors' covis lists
        for other in np.where(self.kf_valid[: self.n_kf])[0]:
            pos = np.where(self.covis_idx[other] == kf)[0]
            for p in pos:
                self.covis_idx[other, p] = -1
                self.covis_w[other, p] = 0
        parent = self.span_parent[kf]
        children = [int(c) for c in np.where(self.span_parent == kf)[0]
                    if self.kf_valid[c]]
        if children and parent >= 0:
            candidates = {int(parent)}
            while children:
                best_w, best_child, best_parent = 0, -1, -1
                for c in children:
                    idx, w = self.covis_idx[c], self.covis_w[c]
                    for j in np.where(idx >= 0)[0]:
                        if int(idx[j]) in candidates and w[j] > best_w:
                            best_w = int(w[j])
                            best_child, best_parent = c, int(idx[j])
                if best_child < 0:
                    break  # no child covises any candidate: fall back
                self.span_parent[best_child] = best_parent
                candidates.add(best_child)
                children.remove(best_child)
        self.span_parent[self.span_parent == kf] = parent
        self.free_kf_pending.append(int(kf))
        # Re-anchor points whose reference KF was just culled: the
        # essential-graph write-back selects points by mp_ref_kf, so a
        # dangling ref would silently skip them during loop correction.
        dangling = np.where(
            self.mp_valid[: self.n_mp] & (self.mp_ref_kf[: self.n_mp] == kf)
        )[0]
        if len(dangling):
            self.mp_ref_kf[dangling] = -1
            self.update_point_attributes(dangling)
            # points with zero live observations cannot be re-anchored
            for mp in dangling[self.mp_ref_kf[dangling] < 0]:
                self.remove_map_point(int(mp))

    def recycle_free_slots(self):
        """Promote pending slots to allocatable. Called once per keyframe
        cycle: any stale reference (tracker frame match, async worker) from
        the previous cycle has been dropped by then, so a recycled slot can
        no longer be bound through a dangling id. A snapshot that outlives
        the cycle (hold_recycling) keeps the slots pending until it is
        released: a global BA's write-back must not land on a slot that a
        new keyframe or point took while it solved."""
        if self.recycle_holds:
            return
        self.free_mp.extend(self.free_mp_pending)
        self.free_mp_pending = []
        if self.free_kf_pending:
            # long-lived structures must not bind a recycled id to a NEW
            # keyframe: drop loop edges that referenced the culled slots
            dead = set(self.free_kf_pending)
            self.loop_edges = [
                (a, b) for a, b in self.loop_edges
                if a not in dead and b not in dead
            ]
            self.free_kf.extend(self.free_kf_pending)
            self.free_kf_pending = []

    def hold_recycling(self) -> object:
        """Keep freed slots pending until release_recycling(token) (no lock
        taken: list.append and list.remove are atomic)."""
        token = object()
        self.recycle_holds.append(token)
        return token

    def release_recycling(self, token: object):
        self.recycle_holds.remove(token)

    def grow(self, new_kf: Optional[int] = None,
             new_mp: Optional[int] = None):
        """Enlarge the fixed-capacity arrays in place (ids are preserved, so
        no remapping — the compaction story for maps that outgrow their
        initial KITTI-scale allocation). Costs one realloc copy at keyframe
        rate, never in the per-frame path."""

        def _pad(arr, axis, extra, fill):
            widths = [(0, 0)] * arr.ndim
            widths[axis] = (0, extra)
            return np.pad(arr, widths, constant_values=fill)

        if new_kf is not None and new_kf > self.kf_valid.shape[0]:
            extra = new_kf - self.kf_valid.shape[0]
            print(f"[map] growing keyframe capacity -> {new_kf}")
            self.dev_kf.invalidate()
            eye = np.tile(np.eye(4, dtype=np.float32), (extra, 1, 1))
            self.kf_pose = np.concatenate([self.kf_pose, eye])
            for name, fill in (
                ("kf_valid", False), ("kf_seq", 0), ("kf_frame_id", 0),
                ("kf_timestamp", 0.0), ("kf_xy", 0.0), ("kf_desc", 0),
                ("kf_octave", 0), ("kf_angle", 0.0), ("kf_ur", -1.0),
                ("kf_depth", -1.0), ("kf_feat_valid", False), ("kf_mp", -1),
                ("covis_idx", -1), ("covis_w", 0), ("span_parent", -1),
            ):
                setattr(self, name, _pad(getattr(self, name), 0, extra, fill))
        if new_mp is not None and new_mp > self.mp_valid.shape[0]:
            extra = new_mp - self.mp_valid.shape[0]
            print(f"[map] growing map-point capacity -> {new_mp}")
            for name, fill in (
                ("mp_pos", 0.0), ("mp_valid", False), ("mp_desc", 0),
                ("mp_normal", 0.0), ("mp_dmin", 0.0), ("mp_dmax", np.inf),
                ("mp_ref_kf", -1), ("mp_first_kf", -1), ("mp_obs_kf", -1),
                ("mp_obs_feat", -1), ("mp_n_obs", 0), ("mp_visible", 0),
                ("mp_found", 0),
            ):
                setattr(self, name, _pad(getattr(self, name), 0, extra, fill))

    # ------------------------------------------------------------------
    def valid_map_points(self) -> np.ndarray:
        return np.where(self.mp_valid[: self.n_mp])[0]

    def valid_keyframes(self) -> np.ndarray:
        return np.where(self.kf_valid[: self.n_kf])[0]

    def keyframe_center(self, kf: int) -> np.ndarray:
        T = self.kf_pose[kf]
        return -T[:3, :3].T @ T[:3, 3]
