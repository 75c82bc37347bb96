"""Loop closing: detection, Sim3 alignment, correction, essential-graph
optimization and global BA (port of ``orbslam2_tpu.loop_closing``).

The reference's order and host bookkeeping, with every device program a
hand-written CUDA kernel on the map's device (its plain PyTorch version on
the CPU):

  DetectLoop        host numpy: minScore over the covisibles, the database's
                    candidates, the creation-sequence gap, the
                    3-consecutive consistency groups
  SearchByBoW       kernel U (mutual, TH_LOW, ratio 0.75, rotation check)
  Sim3 RANSAC       kernel K (``kernels/sim3_ransac.py``)
  SearchBySim3      kernel M's search (``kernels/sim3_search.py``)
  OptimizeSim3      kernel M's LM (``kernels/sim3_opt.py``)
  acceptance count  the loop neighbourhood projected on the host, then
                    kernel C with a 10 px radius, no octave window, TH_LOW
  CorrectLoop       host numpy Sim3 algebra (``ops/sim3_np.py``)
  SearchAndFuse     kernel T at radius 4, one launch over the group
  essential graph   kernel P (``kernels/pose_graph.py``) with F', or past
                    384 keyframe slots kernel P' (``kernels/pose_graph_cg.py``)
  global BA         kernels E, F or F' (6K > 384), G, H (``ops/ba.py``),
                    sized to the live map; past 256 live keyframes the
                    reference's overlapping-window sweep (windows of 256,
                    overlap 64, at most 32768 points a window)

With ``background_gba`` (the asynchronous system sets it) the closure's
global BA runs as a detached task (``launch_global_ba_background``, the
reference's RunGlobalBundleAdjustment thread): it takes the map lock only
to gather and to write back, reads its abort flag between LM chunks, and a
newer closure supersedes a running one. A failure of the task is printed
and kept in ``gba_error`` for the system to raise on its caller's thread.

``global_bundle_adjustment(use_mesh=True)`` shards the landmark axis over
a mesh of devices (``parallel/sharded_ba.py``, slice 10a). Not in this
slice: the edge-sharded essential graph (``runtime.mesh_essential_graph``,
slice 10b), which raises NotImplementedError naming it.
"""

from __future__ import annotations

import threading
import traceback
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from .config import SlamConfig
from .device import on as on_device
from .kernels import fuse_match as _fuse_match
from .kernels import hamming as _hamming
from .kernels import match_rot as _match_rot
from .kernels import pose_graph as _pose_graph
from .kernels import sim3_opt as _sim3_opt
from .kernels import sim3_ransac as _sim3_ransac
from .kernels import sim3_search as _sim3_search
from .map.keyframe_database import KeyFrameDatabase
from .map.state import MapState
from .models.camera import Camera
from .ops import ba, matching, sim3_np
from .parallel import sharded_ba


class LoopCloser:
    def __init__(self, cfg: SlamConfig, slam_map: MapState, cam: Camera,
                 kfdb: KeyFrameDatabase):
        self.cfg = cfg
        self.map = slam_map
        self.cam = cam
        self.kfdb = kfdb
        self.consistent_groups: List[Tuple[Set[int], int]] = []
        self.last_loop_kf = -10**9
        self._rng = np.random.default_rng(cfg.runtime.seed + 1)
        self.loops_closed = 0
        # the last closure's numbers (matches, inliers, GBA size)
        self.last_stats: Dict[str, int] = {}
        # background GBA (RunGlobalBundleAdjustment, mbStopGBA)
        self.background_gba = False  # the asynchronous system turns it on
        self.gba_thread: Optional[threading.Thread] = None
        self.gba_abort = threading.Event()
        self.gba_error: Optional[BaseException] = None  # the first failure

    @property
    def device(self) -> torch.device:
        return torch.device(self.map.device)

    def _t(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    @staticmethod
    def _point_bucket(n: int, lo: int = 2048, hi: int = 65536) -> int:
        """Power-of-two capacity for a point set of size n (the reference's
        buckets); reports the points a full bucket drops."""
        cap = lo
        while cap < n and cap < hi:
            cap *= 2
        if n > cap:
            print(f"[loop] point bucket ceiling: {n - cap} of {n} points "
                  f"dropped (cap {cap})")
        return cap

    # ------------------------------------------------------------------
    def process_keyframe(self, kf: int, run_global_ba: bool = True) -> bool:
        """Returns True if a loop was detected and corrected; adds the
        keyframe to the database after detection."""
        closed = False
        cand = self._detect_loop(kf)
        if cand is not None:
            with self.map.lock:
                ok = self._compute_and_correct(kf, cand, run_global_ba)
            if ok:
                self.last_loop_kf = int(self.map.kf_seq[kf])
                self.loops_closed += 1
                closed = True
        self.kfdb.add(kf)
        return closed

    # ------------------------------------------------------------------
    # DetectLoop
    # ------------------------------------------------------------------
    def _detect_loop(self, kf: int) -> Optional[int]:
        m = self.map
        if m.kf_seq[kf] - self.last_loop_kf < self.cfg.loop.kfs_between_loops:
            return None
        if len(m.valid_keyframes()) < self.cfg.loop.kfs_between_loops:
            return None
        covis = m.covisible_keyframes(kf)
        if len(covis) == 0:
            return None
        # minScore: the lowest similarity to the keyframe's own covisibles
        own_bow = self.kfdb.row(kf)
        cin = np.asarray([int(c) for c in covis if self.kfdb.in_db[int(c)]])
        if len(cin):
            s = 1.0 - 0.5 * np.abs(
                self.kfdb.bow_mat[cin] - own_bow[None, :]).sum(-1)
            min_score = float(s.min())
        else:
            min_score = 0.0
        candidates = self.kfdb.detect_loop_candidates(kf, min_score)
        # a loop is a revisit: creation-sequence distance, independent of
        # how far mapping has connected recent keyframes
        gap = self.cfg.loop.kfs_between_loops
        candidates = [c for c in candidates
                      if abs(int(m.kf_seq[kf]) - int(m.kf_seq[c])) >= gap]
        if not candidates:
            self.consistent_groups = []
            return None
        th = self.cfg.loop.covisibility_consistency_th
        new_groups: List[Tuple[Set[int], int]] = []
        enough: List[int] = []
        for c in candidates:
            group = set(int(x) for x in m.covisible_keyframes(c))
            group.add(c)
            best_consistency = 0
            for prev_group, count in self.consistent_groups:
                if group & prev_group:
                    best_consistency = max(best_consistency, count + 1)
            new_groups.append((group, best_consistency))
            if best_consistency >= th:
                enough.append(c)
        self.consistent_groups = new_groups
        return enough[0] if enough else None

    # ------------------------------------------------------------------
    # ComputeSim3
    # ------------------------------------------------------------------
    def _match_map_points(self, kf1: int, kf2: int):
        """Map-point correspondences of two keyframes through their
        features' descriptors (kernel U: mutual, TH_LOW, ratio 0.75,
        rotation check)."""
        m = self.map
        has1 = m.kf_feat_valid[kf1] & (m.kf_mp[kf1] >= 0)
        has2 = m.kf_feat_valid[kf2] & (m.kf_mp[kf2] >= 0)
        t = self._t
        res = _match_rot.match_rot(
            t(m.kf_desc[kf1]), t(m.kf_desc[kf2]), t(has1), t(has2),
            t(m.kf_angle[kf1]), t(m.kf_angle[kf2]), matching.TH_LOW, 0.75)
        rv = res.valid.cpu().numpy()
        f1 = np.where(rv)[0]
        f2 = res.idx.cpu().numpy()[f1]
        mp1 = m.kf_mp[kf1, f1]
        mp2 = m.kf_mp[kf2, f2]
        live = m.mp_valid[mp1] & m.mp_valid[mp2]
        return f1[live], f2[live], mp1[live], mp2[live]

    def _compute_and_correct(self, kf: int, loop_kf: int,
                             run_global_ba: bool) -> bool:
        m = self.map
        cfg = self.cfg
        f1, f2, mp1, mp2 = self._match_map_points(kf, loop_kf)
        self.last_stats = dict(kf=int(kf), loop_kf=int(loop_kf),
                               bow_matches=len(mp1))
        if len(mp1) < cfg.loop.min_bow_matches:
            return False
        T1 = m.kf_pose[kf]
        T2 = m.kf_pose[loop_kf]
        p1c = m.mp_pos[mp1] @ T1[:3, :3].T + T1[:3, 3]
        p2c = m.mp_pos[mp2] @ T2[:3, :3].T + T2[:3, 3]
        sf = cfg.extractor.scale_factor
        s2_1 = sf ** (2 * m.kf_octave[kf, f1].astype(np.float32))
        s2_2 = sf ** (2 * m.kf_octave[loop_kf, f2].astype(np.float32))
        # the matched points, padded to a multiple of 64 as the reference
        N = len(p1c)
        pad = (64 - N % 64) % 64

        def padv(x, fill=0.0):
            w = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
            return np.pad(x, w, constant_values=fill)

        valid = np.ones(N, bool)
        samples = self._rng.integers(0, N, size=(256, 3)).astype(np.int32)
        fix_scale = cfg.sensor != "monocular"
        t = self._t
        packed = _sim3_ransac.sim3_ransac(
            self.cam, t(padv(p1c.astype(np.float32))),
            t(padv(p2c.astype(np.float32))),
            t(padv(s2_1.astype(np.float32), 1.0)),
            t(padv(s2_2.astype(np.float32), 1.0)), t(padv(valid, False)),
            t(samples), fix_scale=fix_scale,
            min_inliers=cfg.loop.min_sim3_inliers)
        res = _sim3_ransac.unpack(packed.cpu().numpy(), N + pad)
        self.last_stats["ransac_inliers"] = int(res.n_inliers)
        if not res.ok:
            return False
        S12 = res.S12  # loop-keyframe camera coordinates -> current
        # grow the correspondences under the RANSAC estimate (SearchBySim3),
        # then refine S12 over paired reprojection edges (OptimizeSim3)
        inl = res.inliers[:N]
        pairs = self._grow_sim3_matches(kf, loop_kf, S12)
        pairs[f1[inl]] = f2[inl]  # RANSAC inliers always kept
        S12_ref, n_inl = self._refine_sim3(kf, loop_kf, S12, pairs, fix_scale)
        self.last_stats["refined_inliers"] = int(n_inl)
        if n_inl < cfg.loop.min_sim3_inliers:
            return False
        S12 = S12_ref
        n_total = self._count_projected_matches(kf, loop_kf, S12)
        self.last_stats["total_matches"] = int(n_total)
        if n_total < cfg.loop.min_total_matches:
            return False
        self._correct_loop(kf, loop_kf, S12, run_global_ba)
        return True

    def _grow_sim3_matches(self, kf: int, loop_kf: int,
                           S12: np.ndarray) -> np.ndarray:
        """SearchBySim3 (kernel M's search): (N,) int32, the feature of
        loop_kf each feature of kf matches in both directions, else -1."""
        m = self.map

        def side(k):
            mp = m.kf_mp[k]
            safe = np.maximum(mp, 0)
            valid = (mp >= 0) & m.kf_feat_valid[k] & m.mp_valid[safe]
            T = m.kf_pose[k]
            pos_c = m.mp_pos[safe] @ T[:3, :3].T + T[:3, 3]
            return pos_c.astype(np.float32), valid, m.mp_dmax[safe]

        pos1, v1, dmax1 = side(kf)
        pos2, v2, dmax2 = side(loop_kf)
        ecfg = self.cfg.extractor
        t = self._t
        idx2, _ = _sim3_search.search_by_sim3(
            self.cam, t(S12.astype(np.float32)), t(pos1), t(m.kf_desc[kf]),
            t(v1), t(dmax1), t(m.kf_xy[kf]), t(m.kf_octave[kf]), t(pos2),
            t(m.kf_desc[loop_kf]), t(v2), t(dmax2), t(m.kf_xy[loop_kf]),
            t(m.kf_octave[loop_kf]), float(np.float32(ecfg.scale_factor)),
            ecfg.n_levels)
        return idx2.cpu().numpy().copy()

    def _refine_sim3(self, kf: int, loop_kf: int, S12: np.ndarray,
                     pairs: np.ndarray, fix_scale: bool):
        """OptimizeSim3 (kernel M's LM) over the grown correspondences;
        returns the refined transform and its inlier count."""
        m = self.map
        valid = pairs >= 0
        j = np.maximum(pairs, 0)
        mp1 = m.kf_mp[kf]
        mp2 = m.kf_mp[loop_kf, j]
        valid = valid & (mp1 >= 0) & (mp2 >= 0)
        s1 = np.maximum(mp1, 0)
        s2 = np.maximum(mp2, 0)
        valid = valid & m.mp_valid[s1] & m.mp_valid[s2]
        T1 = m.kf_pose[kf]
        T2 = m.kf_pose[loop_kf]
        p1c = (m.mp_pos[s1] @ T1[:3, :3].T + T1[:3, 3]).astype(np.float32)
        p2c = (m.mp_pos[s2] @ T2[:3, :3].T + T2[:3, 3]).astype(np.float32)
        sf = self.cfg.extractor.scale_factor
        s2_1 = sf ** (2 * m.kf_octave[kf].astype(np.float32))
        s2_2 = sf ** (2 * m.kf_octave[loop_kf, j].astype(np.float32))
        t = self._t
        packed = _sim3_opt.optimize_sim3(
            self.cam, t(S12.astype(np.float32)), t(p1c), t(p2c), t(m.kf_xy[kf]),
            t(m.kf_xy[loop_kf, j]), t(s2_1.astype(np.float32)),
            t(s2_2.astype(np.float32)), t(valid), fix_scale=fix_scale)
        res = _sim3_opt.unpack(packed.cpu().numpy(), len(valid))
        return res.S12, int(res.n_inliers)

    def _count_projected_matches(self, kf: int, loop_kf: int, S12) -> int:
        """SearchByProjection(Scw): the loop neighbourhood's points, under
        the corrected pose, against the current keyframe's features (a
        10 px radius, TH_LOW, no ratio, no octave window: kernel C)."""
        m = self.map
        group = [loop_kf] + [int(x) for x in m.covisible_keyframes(loop_kf)]
        mps = np.unique(m.kf_mp[group])
        mps = mps[mps >= 0]
        mps = mps[m.mp_valid[mps]]
        if len(mps) == 0:
            return 0
        cap = self._point_bucket(len(mps))
        mps = mps[:cap]
        S_loop = sim3_np.from_se3(m.kf_pose[loop_kf])
        Scw = sim3_np.compose(S12, S_loop)
        pc = sim3_np.apply(Scw[None], m.mp_pos[mps])
        z = pc[:, 2]
        cam = self.cam
        u = cam.fx * pc[:, 0] / np.maximum(z, 1e-6) + cam.cx
        v = cam.fy * pc[:, 1] / np.maximum(z, 1e-6) + cam.cy
        ok = (z > 0.1) & (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
        if ok.sum() == 0:
            return 0
        P = cap
        sel = np.zeros(P, np.int64)
        n = min(int(ok.sum()), P)
        sel[:n] = mps[ok][:n]
        pv = np.zeros(P, bool)
        pv[:n] = True
        proj = np.zeros((P, 2), np.float32)
        proj[:n] = np.stack([u[ok][:n], v[ok][:n]], 1)
        t = self._t
        N = m.kf_xy.shape[1]
        best_idx, best, _, _ = _hamming.hamming_top2_gated(
            t(m.mp_desc[sel]), t(proj), t(np.full(P, 10.0, np.float32)),
            t(np.zeros(P, np.int32)), t(np.zeros(P, np.float32)), t(pv),
            t(m.kf_desc[kf]), t(m.kf_xy[kf]), t(m.kf_octave[kf]),
            t(m.kf_feat_valid[kf]), t(np.zeros(N, np.float32)),
            octave_window=None)
        return int(((best <= matching.TH_LOW) & t(pv)).sum())

    # ------------------------------------------------------------------
    # CorrectLoop
    # ------------------------------------------------------------------
    def _correct_loop(self, kf: int, loop_kf: int, S12: np.ndarray,
                      run_global_ba: bool):
        group, pre_poses, corrected = self._correct_group(kf, loop_kf, S12)
        self._search_and_fuse(kf, loop_kf, group)
        self._optimize_essential_graph(kf, loop_kf, pre_poses, corrected)
        if run_global_ba:
            if self.background_gba:
                self.launch_global_ba_background()
            else:
                self.global_bundle_adjustment()

    # ------------------------------------------------------------------
    # Background global BA (RunGlobalBundleAdjustment, mbStopGBA)
    # ------------------------------------------------------------------
    def launch_global_ba_background(self):
        """Start global BA as its own task; a running one is superseded:
        its abort flag is set and it is joined first (it leaves at its next
        LM chunk or lock wait, discarding its result)."""
        if self.gba_thread is not None and self.gba_thread.is_alive():
            self.gba_abort.set()
            self.gba_thread.join(timeout=60.0)
            if self.gba_thread.is_alive():
                raise TimeoutError("the superseded global BA did not stop in 60 s")
        self.gba_abort.clear()
        self.gba_thread = threading.Thread(target=self._gba_task,
                                           name="global-ba", daemon=True)
        self.gba_thread.start()

    def wait_global_ba(self, timeout: Optional[float] = None) -> bool:
        """Join a running global BA; False if it still runs after
        ``timeout`` seconds."""
        if self.gba_thread is not None and self.gba_thread.is_alive():
            self.gba_thread.join(timeout)
            return not self.gba_thread.is_alive()
        return True

    def _gba_task(self):
        try:
            with on_device(self.device):
                self.global_bundle_adjustment(abort_check=self.gba_abort.is_set)
        except Exception as e:  # the task's boundary: report and keep it
            traceback.print_exc()
            print(f"[global BA] task failed: {e!r}")
            if self.gba_error is None:
                self.gba_error = e

    def _correct_group(self, kf: int, loop_kf: int, S12: np.ndarray):
        """The corrected Sim3 of the current keyframe and its covisible
        group; their poses and points moved (host numpy). Returns (group,
        pre-correction poses, corrected Sim3 by keyframe)."""
        m = self.map
        pre_poses = {int(k): m.kf_pose[k].copy() for k in m.valid_keyframes()}
        S_loop = sim3_np.from_se3(m.kf_pose[loop_kf])
        Scw_cur = sim3_np.compose(S12.astype(np.float32), S_loop)
        group = [kf] + [int(x) for x in m.covisible_keyframes(kf)]
        T_cur = m.kf_pose[kf]
        T_grp = m.kf_pose[np.asarray(group)]
        S_k_c = sim3_np.from_se3(
            (T_grp @ np.linalg.inv(T_cur)[None]).astype(np.float32))
        corr_arr = sim3_np.compose(S_k_c, Scw_cur[None])
        corrected: Dict[int, np.ndarray] = {
            k: corr_arr[i] for i, k in enumerate(group)}
        # the epoch bump makes mapper work gathered before this moment
        # discard its commit
        m.correction_epoch += 1
        moved = np.zeros(m.n_mp, bool)
        for i, k in enumerate(group):
            mps = np.unique(m.kf_mp[k])
            mps = mps[mps >= 0]
            mps = mps[m.mp_valid[mps] & ~moved[mps]]
            if len(mps):
                moved[mps] = True
                M = sim3_np.compose(sim3_np.inverse(corr_arr[i]),
                                    sim3_np.from_se3(pre_poses[k]))
                m.mp_pos[mps] = sim3_np.apply(M[None], m.mp_pos[mps])
            m.kf_pose[k] = sim3_np.to_se3(corr_arr[i])
        m.loop_edges.append((kf, loop_kf))
        m.version += 1
        return group, pre_poses, corrected

    def _search_and_fuse(self, kf: int, loop_kf: int, group):
        """Project the loop neighbourhood's points into each corrected group
        keyframe (kernel T, radius 4, all keyframes in one launch) and
        replace matched duplicates: the loop point wins."""
        m = self.map
        sf = self.cfg.extractor.scale_factor
        loop_group = [loop_kf] + [int(x) for x in m.covisible_keyframes(loop_kf)]
        mps = np.unique(m.kf_mp[loop_group])
        mps = mps[mps >= 0]
        mps = mps[m.mp_valid[mps]]
        if len(mps) == 0:
            return
        P = self._point_bucket(len(mps))
        sel = np.zeros(P, np.int64)
        n = min(len(mps), P)
        sel[:n] = mps[:n]
        pv = np.zeros(P, bool)
        pv[:n] = True
        dsts = [g for g in group if m.kf_valid[g]]
        if not dsts:
            return
        # the points, poses and features are not changed by the commits
        # below, so every destination is matched in one launch
        Dn = len(dsts)
        t = self._t
        mir = m.dev_kf.ensure(m)
        dst = t(np.asarray(dsts, np.int64))
        res = _fuse_match.fuse_match(
            t(m.mp_pos[sel])[None].expand(Dn, P, 3).contiguous(),
            t(m.mp_desc[sel])[None].expand(Dn, P, 32).contiguous(),
            t(pv)[None].expand(Dn, P).contiguous(), t(m.kf_pose[dsts]),
            mir["kf_xy"][dst], mir["kf_desc"][dst], mir["kf_octave"][dst],
            mir["kf_feat_valid"][dst], self.cam, float(np.float32(sf)), 4.0)
        rv_d = res.valid.cpu().numpy()
        ridx_d = res.idx.cpu().numpy()
        touched = set()
        for di, dst_kf in enumerate(dsts):
            for row in np.where(rv_d[di])[0]:
                loop_mp = int(sel[row])
                if not m.mp_valid[loop_mp]:
                    continue
                feat = int(ridx_d[di, row])
                existing = int(m.kf_mp[dst_kf, feat])
                if existing >= 0 and m.mp_valid[existing]:
                    if existing != loop_mp:
                        m.replace_map_point(existing, loop_mp)
                        touched.add(loop_mp)
                else:
                    m.add_observation(loop_mp, dst_kf, feat)
                    touched.add(loop_mp)
        if touched:
            m.update_point_attributes(np.fromiter(touched, dtype=np.int64))
            for g in group:
                if m.kf_valid[g]:
                    m.update_connections(g)

    def _essential_edges(self):
        """Spanning tree + strong covisibility + loop edges."""
        m = self.map
        edges = set()
        for k in m.valid_keyframes():
            k = int(k)
            p = int(m.span_parent[k])
            if p >= 0 and m.kf_valid[p]:
                edges.add((min(k, p), max(k, p)))
            for nb, wt in zip(m.covis_idx[k], m.covis_w[k]):
                if (nb >= 0 and wt >= self.cfg.mapping.essential_graph_weight
                        and m.kf_valid[nb]):
                    edges.add((min(k, int(nb)), max(k, int(nb))))
        for a, b in m.loop_edges:
            if m.kf_valid[a] and m.kf_valid[b]:
                edges.add((min(a, b), max(a, b)))
        return sorted(edges)

    def _optimize_essential_graph(self, kf, loop_kf, pre_poses, corrected):
        m = self.map
        cfg = self.cfg
        if cfg.runtime.mesh_essential_graph:
            raise NotImplementedError(
                "the edge-sharded essential graph comes with ROADMAP slice 10b")
        K = m.n_kf
        S_init = np.zeros((K, 8), np.float32)
        S_init[:, 0] = 1.0
        S_init[:, 1] = 1.0
        valid = m.kf_valid[:K].copy()
        vk = np.where(valid)[0]
        S_init[vk] = sim3_np.from_se3(m.kf_pose[vk].astype(np.float32))
        edges = self._essential_edges()
        if len(edges) < 2:
            return
        # measurements from the pre-correction poses, except edges inside
        # the corrected set and the loop edge, which use corrected poses
        loop_edge = (min(kf, loop_kf), max(kf, loop_kf))

        def end_sim3(a, use_corr):
            if use_corr and a in corrected:
                return corrected[a]
            T = pre_poses.get(a, m.kf_pose[a])
            return sim3_np.from_se3(T.astype(np.float32))

        Sa_l, Sb_l, ei, ej = [], [], [], []
        for a, b in edges:
            use_corr = (a in corrected and b in corrected) or (a, b) == loop_edge
            ei.append(a)
            ej.append(b)
            Sa_l.append(end_sim3(a, use_corr))
            Sb_l.append(end_sim3(b, use_corr))
        Sij = sim3_np.compose(np.stack(Sa_l), sim3_np.inverse(np.stack(Sb_l)))
        fixed = np.zeros(K, bool)
        fixed[loop_kf] = True
        order = np.argsort(np.where(valid, m.kf_seq[:K],
                                    np.iinfo(np.int64).max)).astype(np.int32)
        t = self._t
        S_opt = _pose_graph.optimize_pose_graph(
            t(S_init), t(fixed), t(valid), t(np.asarray(ei, np.int32)),
            t(np.asarray(ej, np.int32)), t(Sij.astype(np.float32)),
            t(np.ones(len(ei), bool)), iters=cfg.runtime.essential_graph_iters,
            fix_scale=cfg.sensor != "monocular", order=t(order)
        ).poses.cpu().numpy()
        # write back poses ([R t/s]) and move each point with its reference
        # keyframe: p' = S_opt^-1 (S_init p), S_init being the pose set the
        # points are consistent with now (the group already corrected)
        M = sim3_np.compose(sim3_np.inverse(S_opt[vk]), S_init[vk])
        mp_done = np.zeros(m.n_mp, bool)
        for i, k in enumerate(vk):
            mps = np.where((m.mp_ref_kf[: m.n_mp] == k) & m.mp_valid[: m.n_mp]
                           & ~mp_done[: m.n_mp])[0]
            if len(mps):
                m.mp_pos[mps] = sim3_np.apply(M[i][None], m.mp_pos[mps])
                mp_done[mps] = True
        m.kf_pose[vk] = sim3_np.to_se3(S_opt[vk])
        m.update_point_attributes(np.where(mp_done)[0])

    # ------------------------------------------------------------------
    # Global BA
    # ------------------------------------------------------------------
    # the reference's single-solve size buckets (K keyframes, M points)
    _GBA_BUCKETS = ((32, 4096), (64, 8192), (128, 16384), (256, 32768))

    def global_bundle_adjustment(self, iters: Optional[int] = None,
                                 max_kfs: Optional[int] = None,
                                 max_points: Optional[int] = None,
                                 obs_cap: int = 8, use_mesh: bool = False,
                                 abort_check=None, chunk: int = 5,
                                 sweep_window: Optional[int] = None,
                                 sweep_points: Optional[int] = None,
                                 sweep_overlap: int = 64, mesh=None):
        """Full-map BA with snapshot semantics: gathered under the map lock,
        solved without it (in ``chunk``-iteration pieces when an
        ``abort_check`` is given, which is honoured between pieces), written
        back under the lock with the spanning-tree propagation to keyframes
        and points outside the solve. Past the largest single-solve bucket
        (``sweep_window`` keyframes, 256 by default) the whole map is
        optimized by the overlapping-window sweep (``_gba_sweep``);
        ``sweep_points`` and ``sweep_overlap`` set its other sizes. Slots
        freed while it runs are recycled only after its write-back
        (``MapState.hold_recycling``). ``use_mesh`` solves the gathered
        problem (no sweep) landmark-sharded over ``mesh``
        (``parallel.sharded_ba``; by default every visible card), or, with
        an ``abort_check``, in chunks on this closer's device, as the
        reference does."""
        token = self.map.hold_recycling()
        try:
            return self._global_ba(iters, max_kfs, max_points, obs_cap, use_mesh,
                                   abort_check, chunk, sweep_window,
                                   sweep_points, sweep_overlap, mesh)
        finally:
            self.map.release_recycling(token)

    def _global_ba(self, iters, max_kfs, max_points, obs_cap, use_mesh,
                   abort_check, chunk, sweep_window, sweep_points, sweep_overlap,
                   mesh):
        m = self.map
        iters = iters or self.cfg.runtime.global_ba_iters
        if max_kfs is None and not use_mesh:
            n_live_kf = len(m.valid_keyframes())
            win = sweep_window or self._GBA_BUCKETS[-1][0]
            if n_live_kf > win:
                return self._gba_sweep(
                    iters, obs_cap, abort_check, chunk, window=win,
                    max_points=sweep_points or self._GBA_BUCKETS[-1][1],
                    overlap=sweep_overlap)
        if not self._lock_abortable(abort_check):
            return
        try:
            snap = self._gba_gather(max_kfs, max_points, obs_cap)
        finally:
            m.lock.release()
        if snap is None:
            return
        prob, kfs, mp_ids, opt_mask, n_ids = snap
        if abort_check is None:
            res = (self._gba_solve_mesh(prob, iters, mesh) if use_mesh
                   else self._gba_solve(prob, iters))
        else:
            res = self._solve_chunked(prob, iters, abort_check, chunk)
            if res is None:
                return  # superseded: the result is discarded
        if not self._lock_abortable(abort_check):
            return
        try:
            self._gba_write_back(kfs, opt_mask, res.poses.cpu().numpy(),
                                 mp_ids, res.points.cpu().numpy()[:n_ids])
            m.version += 1
        finally:
            m.lock.release()

    def _lock_abortable(self, abort_check) -> bool:
        """Acquire the map lock, polling the abort flag while blocked (a
        superseding loop closure holds the lock while it waits for the
        running GBA); False if the flag won."""
        if abort_check is None:
            self.map.lock.acquire()
            return True
        while not self.map.lock.acquire(timeout=0.05):
            if abort_check():
                return False
        return True

    def _gba_gather(self, max_kfs, max_points, obs_cap: int, kfs=None,
                    fixed_prefix: int = 1):
        """The GBA problem: the keyframes ``kfs`` (a sweep window, in
        creation order) or, without them, the live keyframes in creation
        order, the newest ``max_kfs`` kept when there are more (both sizes
        from the reference's buckets when not given, with its print past
        the largest); the first ``fixed_prefix`` held fixed; the live points
        they observe, at most ``max_points``; ``obs_cap`` slots. The
        reference pads K and M to its buckets, which changes no solution
        (``ops.ba.pad_problem``); the port gathers the live size."""
        m = self.map
        if kfs is None:
            n_live_kf = len(m.valid_keyframes())
            n_live_mp = len(m.valid_map_points())
            if max_kfs is None or max_points is None:
                for bk, bp in self._GBA_BUCKETS:
                    if n_live_kf <= bk and n_live_mp <= bp:
                        max_kfs, max_points = bk, bp
                        break
                else:
                    max_kfs, max_points = self._GBA_BUCKETS[-1]
                    print(f"[global BA] map ({n_live_kf} KFs, {n_live_mp} pts) "
                          f"exceeds largest bucket {self._GBA_BUCKETS[-1]}; "
                          f"optimizing the newest window (older poses propagate "
                          f"through the spanning tree at write-back)")
            kfs = sorted((int(k) for k in m.valid_keyframes()),
                         key=lambda k: int(m.kf_seq[k]))
            kfs = kfs[-max_kfs:]
        else:
            kfs = [int(k) for k in kfs if m.kf_valid[k]]
        if len(kfs) < 2:
            return None
        in_window = np.zeros(m.n_kf, bool)
        in_window[np.asarray(kfs)] = True
        mp_all = m.valid_map_points()
        obs_in = in_window[np.maximum(m.mp_obs_kf[mp_all], 0)] & (
            m.mp_obs_kf[mp_all] >= 0)
        mp_ids = mp_all[obs_in.any(1)]
        if len(mp_ids) > max_points:
            print(f"[global BA] point budget: {len(mp_ids) - max_points} of "
                  f"{len(mp_ids)} window points beyond cap {max_points} move "
                  f"with their reference KF instead of being optimized")
            mp_ids = mp_ids[:max_points]
        n_ids = len(mp_ids)
        Kw, Mw, Ow = len(kfs), n_ids, obs_cap
        poses = m.kf_pose[kfs].astype(np.float32)
        opt_mask = np.zeros(Kw, bool)
        opt_mask[fixed_prefix:] = True
        w_of_kf = np.full(max(m.n_kf, 1), -1, np.int32)
        w_of_kf[np.asarray(kfs)] = np.arange(len(kfs), dtype=np.int32)
        raw_kf = m.mp_obs_kf[mp_ids]
        raw_ft = m.mp_obs_feat[mp_ids]
        wi = np.where(raw_kf >= 0, w_of_kf[np.maximum(raw_kf, 0)], -1)
        has = wi >= 0
        order = np.argsort(~has, axis=1, kind="stable")[:, :Ow]
        rows = np.arange(n_ids)[:, None]
        wi_c = wi[rows, order]
        has_c = has[rows, order]
        kf_c = np.maximum(raw_kf[rows, order], 0)
        ft_c = np.maximum(raw_ft[rows, order], 0)
        sf = self.cfg.extractor.scale_factor
        points = m.mp_pos[mp_ids].astype(np.float32)
        point_valid = np.ones(Mw, bool)
        obs_kf_t = np.where(has_c, wi_c, -1).astype(np.int32)
        xy = m.kf_xy[kf_c, ft_c]
        ur = m.kf_ur[kf_c, ft_c]
        obs_uvr = np.concatenate([xy, ur[..., None]], axis=2).astype(np.float32)
        obs_s2 = (sf ** (2.0 * m.kf_octave[kf_c, ft_c])).astype(np.float32)
        prob = ba.BAProblem(*(self._t(a) for a in (
            poses, opt_mask, points, point_valid, obs_kf_t, obs_uvr, obs_s2,
            has_c)))
        return prob, kfs, mp_ids, opt_mask, n_ids

    def _solve_chunked(self, prob, iters: int, abort_check, chunk: int):
        """LM in ``chunk``-iteration calls of the BA schedule (each restarts
        lambda; the outlier round only in the last), the abort flag read
        between calls. None when superseded."""
        res = None
        done = 0
        while done < iters:
            n = min(chunk, iters - done)
            last = done + n >= iters
            res = ba.optimize_ba(self.cam, prob, iters=n,
                                 outlier_rounds=1 if last else 0)
            prob = prob._replace(poses=res.poses, points=res.points)
            done += n
            if abort_check is not None and abort_check() and not last:
                return None
        return res

    def _gba_sweep(self, iters: int, obs_cap: int, abort_check, chunk: int,
                   window: int, max_points: int, overlap: int = 64):
        """Whole-map GBA past the largest single-solve bucket: overlapping
        windows of ``window`` keyframes in creation order, swept oldest to
        newest, each step ``window - overlap``. The first window fixes its
        first keyframe, each later one the ``overlap`` keyframes the
        previous window optimized, so every keyframe pose is optimized and
        the corrections chain forward. Points are written back per window
        (the last window wins where windows overlap) and the correction
        epoch bumped each time; keyframes outside every window and points
        never selected follow through ``_propagate_unoptimized`` at the
        end, each keyframe against the pose it had when it first appeared
        in a window."""
        m = self.map
        if not self._lock_abortable(abort_check):
            return
        try:
            all_kfs = sorted((int(k) for k in m.valid_keyframes()),
                             key=lambda k: int(m.kf_seq[k]))
        finally:
            m.lock.release()
        step = max(window - overlap, 1)
        n_win = 1 + max(0, -(-(len(all_kfs) - window) // step))
        print(f"[global BA] sweep: {len(all_kfs)} KFs in {n_win} windows "
              f"of {window} (overlap {overlap})")
        eff_bef: Dict[int, np.ndarray] = {}
        eff_new: Dict[int, np.ndarray] = {}
        mp_opt = np.zeros(m.mp_valid.shape[0], bool)
        start = 0
        while True:
            wk = all_kfs[start: start + window]
            fixed_prefix = 1 if start == 0 else min(overlap, len(wk) - 1)
            if not self._lock_abortable(abort_check):
                return
            try:
                snap = self._gba_gather(window, max_points, obs_cap, kfs=wk,
                                        fixed_prefix=fixed_prefix)
            finally:
                m.lock.release()
            if snap is not None:
                prob, kfs_w, mp_ids, opt_mask, n_ids = snap
                res = self._solve_chunked(prob, iters, abort_check, chunk)
                if res is None:
                    return  # superseded mid-sweep: completed windows stand
                new_poses = res.poses.cpu().numpy()
                new_points = res.points.cpu().numpy()[:n_ids]
                if not self._lock_abortable(abort_check):
                    return
                try:
                    m.correction_epoch += 1
                    for w, k in enumerate(kfs_w):
                        if not m.kf_valid[k]:
                            continue
                        eff_bef.setdefault(k, m.kf_pose[k].copy())
                        T = new_poses[w] if opt_mask[w] else m.kf_pose[k].copy()
                        eff_new[k] = T
                        m.kf_pose[k] = T
                    sel = m.mp_valid[mp_ids]
                    live = mp_ids[sel]
                    m.mp_pos[live] = new_points[sel]
                    mp_opt[live] = True
                finally:
                    m.lock.release()
            if start + window >= len(all_kfs):
                break
            start += step
        if not self._lock_abortable(abort_check):
            return
        try:
            m.correction_epoch += 1
            self._propagate_unoptimized(eff_bef, eff_new, mp_opt)
            m.version += 1
        finally:
            m.lock.release()

    def _gba_solve(self, prob, iters: int):
        return ba.optimize_ba(cam=self.cam, prob=prob, iters=iters)

    def _gba_solve_mesh(self, prob, iters: int, mesh=None):
        """The reference's ``_gba_solve(use_mesh=True)``: the landmark axis
        sharded over ``mesh`` (by default every visible card), padded to
        divide by it with invalid, observation-free points
        (``ops.ba.pad_problem``), the camera system summed once an LM
        iteration."""
        mesh = mesh or sharded_ba.make_landmark_mesh()
        K, M = prob.poses.shape[0], prob.points.shape[0]
        padded = ba.pad_problem(prob, K, -(-M // mesh.size) * mesh.size)
        fn = sharded_ba.make_sharded_ba(mesh, iters=iters)
        return fn(self.cam, sharded_ba.shard_problem(mesh, padded))

    def _gba_write_back(self, kfs, opt_mask, new_poses, mp_ids, new_points):
        """Apply the GBA result, propagating the correction to keyframes and
        points outside the solve (the "before" poses taken now, at
        write-back)."""
        m = self.map
        m.correction_epoch += 1
        eff_bef: Dict[int, np.ndarray] = {}
        eff_new: Dict[int, np.ndarray] = {}
        for w, k in enumerate(kfs):
            if not m.kf_valid[k]:
                continue
            eff_bef[k] = m.kf_pose[k].copy()
            eff_new[k] = new_poses[w] if opt_mask[w] else eff_bef[k]
        sel = m.mp_valid[mp_ids]
        live_ids = mp_ids[sel]
        m.mp_pos[live_ids] = new_points[sel]
        in_ids = np.zeros(m.mp_valid.shape[0], bool)
        in_ids[live_ids] = True
        self._propagate_unoptimized(eff_bef, eff_new, in_ids)

    def _propagate_unoptimized(self, eff_bef, eff_new, mp_moved):
        """Keyframes outside the optimized set follow their nearest
        optimized spanning-tree ancestor; points never optimized move with
        their reference keyframe; then the keyframe poses are committed."""
        m = self.map
        in_snap = set(eff_new)
        for k in [int(x) for x in m.valid_keyframes()]:
            if k in in_snap:
                continue
            anc = k
            hops = 0
            while anc >= 0 and anc not in in_snap and hops <= m.n_kf:
                anc = int(m.span_parent[anc])
                hops += 1
            if anc < 0 or anc not in in_snap:
                continue
            bef_cur = m.kf_pose[k].copy()
            T_rel = bef_cur @ np.linalg.inv(eff_bef[anc])
            eff_bef[k] = bef_cur
            eff_new[k] = (T_rel @ eff_new[anc]).astype(np.float32)
        others = np.where(m.mp_valid[: m.n_mp] & ~mp_moved[: m.n_mp])[0]
        for mp in others:
            rk = int(m.mp_ref_kf[mp])
            if rk not in eff_new:
                continue
            pc = eff_bef[rk][:3, :3] @ m.mp_pos[mp] + eff_bef[rk][:3, 3]
            Twc = np.linalg.inv(eff_new[rk])
            m.mp_pos[mp] = Twc[:3, :3] @ pc + Twc[:3, 3]
        for k, T in eff_new.items():
            m.kf_pose[k] = T
