"""Local mapping: keyframe processing, point creation/fusion, local BA, culling
(port of ``orbslam2_tpu.local_mapping``).

Re-design of the reference's LocalMapping (SURVEY §3.3): a pipeline stage
invoked per keyframe. The device steps run on gathered fixed-capacity
windows on the map's device: epipolar matching and triangulation over all
neighbours (kernel S), the projection fuse over all 2N directions (kernel
T), the point attributes (kernel N) and local BA (kernels E-H); the graph
bookkeeping stays host-side on the single-writer MapState, unchanged from
the reference.

``keyframe_phases`` splits one keyframe's round into the phases the
asynchronous system's mapping worker runs, each taking the map lock for
its host reads and writes only. Under a backlog of keyframes the fuse and
local BA are skipped (at most ``max_skip_streak`` keyframes in a row), and
a keyframe that arrives while local BA runs interrupts it between LM chunks.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .config import SlamConfig
from .kernels import fuse_match as _fuse_match
from .kernels import triangulate as _triangulate
from .map.state import MapState
from .models.camera import Camera
from .ops import ba


class LocalMapper:
    def __init__(self, cfg: SlamConfig, slam_map: MapState, cam: Camera):
        self.cfg = cfg
        self.map = slam_map
        self.cam = cam
        self.device = torch.device(slam_map.device)
        self._K_np = cam.K
        self._bf = float(cam.bf)
        self._baseline = self._bf / max(float(self._K_np[0, 0]), 1e-8)
        self.recent_points: List[Tuple[int, int]] = []  # (mp, created_at_kf)
        self.obs_cap = 8  # window observation cap for local BA
        # points whose attributes (distinctive descriptor / normal / depth
        # band) changed this keyframe round; ONE batched refresh runs at the
        # end of the round instead of one per phase, as in the reference
        self._attrs_pending: set = set()
        # the system's hooks: the keyframe database's precompute_async (the
        # BoW vector launched at the start of the round), "another keyframe
        # waits" (interrupts local BA between LM chunks, InterruptBA) and
        # "two or more wait" (skips fuse and BA, at most max_skip_streak
        # keyframes in a row, so a permanent backlog still fuses)
        self.bow_precompute = lambda kf: None
        self.interrupt = lambda: False
        self.backlog = lambda: False
        self.max_skip_streak = 2
        self._skip_streak = 0
        self._skip_now = False
        self.skipped = 0  # keyframes whose fuse and BA the backlog skipped
        # moving average of a keyframe round's seconds, kept by the worker
        # that drives the rounds; the tracker paces its keyframes by it
        self.kf_proc_ema_s = 0.0

    def note_kf_processed(self, seconds: float, alpha: float = 0.3):
        if self.kf_proc_ema_s == 0.0:
            self.kf_proc_ema_s = seconds
        else:
            self.kf_proc_ema_s += alpha * (seconds - self.kf_proc_ema_s)

    # ------------------------------------------------------------------
    def process_keyframe(self, kf: int, run_ba: bool = True):
        for phase in self.keyframe_phases(kf, run_ba):
            phase()

    def keyframe_phases(self, kf: int, run_ba: bool = True):
        """The ProcessNewKeyFrame pipeline for one keyframe, in the
        reference's order, as phases the worker runs one by one. The
        host-only phases hold the map lock throughout; create, fuse and BA
        take it around their gather and commit only, so the tracker's
        keyframe insertion waits for one phase at most, never for the
        device."""
        lock = self.map.lock

        def locked(fn):
            def run():
                with lock:
                    fn()
            return run

        def finish():
            self._flush_attrs_pending()
            self._cull_keyframes(kf)
            self.map.version += 1

        def fuse_phase():
            # one skip decision per keyframe, the streak bounded
            self._skip_now = (self.backlog()
                              and self._skip_streak < self.max_skip_streak)
            if self._skip_now:
                self._skip_streak += 1
                self.skipped += 1
                return
            self._skip_streak = 0
            self._fuse_neighbors(kf)

        def ba_phase():
            if not self._skip_now:
                self.local_bundle_adjustment(kf)

        phases = [
            lambda: self.bow_precompute(kf),
            locked(self.map.recycle_free_slots),
            locked(lambda: self._refresh_tracked_points(kf)),
            locked(lambda: self._cull_map_points(kf)),
            lambda: self._create_new_points(kf),
            fuse_phase,
        ]
        if run_ba:
            phases.append(ba_phase)
        phases.append(locked(finish))
        return phases

    # ------------------------------------------------------------------
    # ProcessNewKeyFrame (†LocalMapping::ProcessNewKeyFrame): refresh the
    # distinctive descriptor / normal / depth band of every pre-existing
    # point the new keyframe now observes. The tracker only binds the
    # observations (cheap); this full median-Hamming pass runs here, off
    # the tracking thread in async mode.
    # ------------------------------------------------------------------
    def _refresh_tracked_points(self, kf: int):
        m = self.map
        mps = m.kf_mp[kf]
        mps = np.unique(mps[mps >= 0])
        # only points with >1 observation need the refresh: fresh
        # single-observation spawns were closed-form-initialized at creation
        mps = mps[m.mp_n_obs[mps] > 1]
        self._attrs_pending.update(int(x) for x in mps)

    def _flush_attrs_pending(self):
        """ONE batched attribute refresh for every point this keyframe
        round touched (new observations from the tracker, triangulated
        points, fuse merges)."""
        if not self._attrs_pending:
            return
        mps = np.fromiter(self._attrs_pending, dtype=np.int64)
        self._attrs_pending.clear()
        self.map.update_point_attributes(mps)

    # ------------------------------------------------------------------
    # MapPointCulling (†LocalMapping::MapPointCulling, SURVEY §2.9)
    # ------------------------------------------------------------------
    def _cull_map_points(self, current_kf: int):
        m = self.map
        keep: List[Tuple[int, int]] = []
        min_obs = 2 if self.cfg.sensor == "monocular" else 3
        for mp, born in self.recent_points:
            if not m.mp_valid[mp] or m.mp_first_kf[mp] != born:
                continue  # dead, or the slot was recycled for a new point
            age = current_kf - born
            found_ratio = m.mp_found[mp] / max(m.mp_visible[mp], 1)
            if found_ratio < self.cfg.mapping.mp_cull_found_ratio:
                m.remove_map_point(mp)
            elif age >= 2 and m.mp_n_obs[mp] <= min_obs:
                m.remove_map_point(mp)
            elif age >= 3:
                pass  # survived the probation window
            else:
                keep.append((mp, born))
        self.recent_points = keep

    # ------------------------------------------------------------------
    # CreateNewMapPoints (†LocalMapping::CreateNewMapPoints)
    # ------------------------------------------------------------------
    def _create_new_points(self, kf: int):
        """Gather under the map lock, run the triangulation kernel WITHOUT
        it (device work must not stall the tracker's keyframe
        insertion), commit under the lock with availability re-checked
        against the current map."""
        m = self.map
        cfg = self.cfg
        with m.lock:
            epoch = m.correction_epoch
            gathered = self._create_new_points_gather(kf)
        if gathered is None:
            return
        nb_arr, n_nbs, args = gathered
        out = _triangulate.triangulate(*args)
        X_all, good_all, idx_all = (t.cpu().numpy() for t in out)
        with m.lock:
            if m.correction_epoch != epoch:
                # a loop correction / GBA rewrote the geometry while the
                # kernel ran: these triangulations live in the OLD frame
                print("[mapping] discarding stale triangulation "
                      "(correction landed mid-flight)")
                return
            self._create_new_points_commit(
                kf, nb_arr, n_nbs, X_all, good_all, idx_all
            )

    def _create_new_points_gather(self, kf: int):
        m = self.map
        cfg = self.cfg
        n_nb = cfg.mapping.triangulation_neighbors
        if cfg.sensor != "monocular":
            n_nb = max(n_nb // 2, 1)
        neighbors = m.covisible_keyframes(kf, n_nb)
        if len(neighbors) == 0:
            return None
        K = self._K_np
        T1 = m.kf_pose[kf]
        C1 = m.keyframe_center(kf)
        med_depth1 = self._median_depth(kf)

        # host-side neighbor admission (pose-only baseline gates)
        nbs = []
        for nb in neighbors:
            nb = int(nb)
            baseline = float(np.linalg.norm(m.keyframe_center(nb) - C1))
            if cfg.sensor == "monocular":
                if med_depth1 > 0 and baseline / med_depth1 < 0.01:
                    continue  # †baseline/medianDepth gate
            else:
                if baseline < self._baseline:
                    continue
            nbs.append(nb)
        if not nbs:
            return None

        # pad the neighbor axis to the configured cap so the kernel shape is
        # stable across keyframes (padding rows carry nb_ok=False)
        B = n_nb
        pad = [nbs[0]] * (B - len(nbs))
        nb_arr = np.asarray(nbs + pad, np.int64)
        nb_ok = np.zeros(B, bool)
        nb_ok[: len(nbs)] = True

        avail1 = m.kf_feat_valid[kf] & (m.kf_mp[kf] < 0)
        avail2 = m.kf_feat_valid[nb_arr] & (m.kf_mp[nb_arr] < 0)
        mir = m.dev_kf.ensure(m)
        dev = self.device
        nb_t = torch.from_numpy(nb_arr).to(dev)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        args = (
            mir["kf_desc"][kf], mir["kf_xy"][kf], mir["kf_octave"][kf],
            t(avail1), mir["kf_depth"][kf], mir["kf_ur"][kf], t(T1),
            mir["kf_desc"][nb_t], mir["kf_xy"][nb_t], mir["kf_octave"][nb_t],
            t(avail2), mir["kf_depth"][nb_t], mir["kf_ur"][nb_t],
            t(m.kf_pose[nb_arr]), t(nb_ok), t(K.astype(np.float32)),
            float(np.float32(self._baseline)), float(np.float32(self._bf)),
            float(np.float32(cfg.extractor.scale_factor)),
        )
        return nb_arr, len(nbs), args

    def _create_new_points_commit(self, kf, nb_arr, n_nbs, X_all, good_all,
                                  idx_all):
        m = self.map
        if not m.kf_valid[kf]:
            return
        # availability re-read at commit time: the tracker may have bound
        # observations while the kernel ran
        avail1 = m.kf_feat_valid[kf] & (m.kf_mp[kf] < 0)
        good = good_all[:n_nbs] & avail1[None, :]           # (B, N)
        if not good.any():
            return
        # first neighbor to claim a feature wins (the sequential loop's
        # avail1-update semantics), vectorized: argmax over the padded
        # neighbor axis picks the lowest claiming b per feature
        feat_ids = np.where(good.any(axis=0))[0]
        claim_b = np.argmax(good[:, feat_ids], axis=0)      # (F,)
        idx2 = idx_all[claim_b, feat_ids]
        # one neighbor feature backs at most one new point (first wins,
        # matching the sequential loop's claim order)
        _, first = np.unique(claim_b.astype(np.int64) * 100000 + idx2,
                             return_index=True)
        keep = np.zeros(len(feat_ids), bool)
        keep[first] = True
        feat_ids, claim_b, idx2 = feat_ids[keep], claim_b[keep], idx2[keep]
        X = X_all[claim_b, feat_ids].astype(np.float32)
        new_mps = m.add_map_points_batch(X, kf)
        m.add_observations_batch(new_mps, kf, feat_ids)
        for b in np.unique(claim_b):
            rows = claim_b == b
            m.add_observations_batch(
                new_mps[rows], int(nb_arr[b]), idx2[rows]
            )
        self.recent_points.extend((int(mp), kf) for mp in new_mps)
        # closed-form init from the current keyframe's observation (the
        # full median-Hamming refresh over both observations runs once at
        # the end of the round via _flush_attrs_pending; with 2 obs the
        # median picks either descriptor, so the init is near-equivalent)
        m.init_point_attributes(new_mps, kf, feat_ids)
        self._attrs_pending.update(int(mp) for mp in new_mps)
        m.update_connections(kf)

    def _median_depth(self, kf: int) -> float:
        m = self.map
        mps = m.kf_mp[kf]
        mps = mps[mps >= 0]
        if len(mps) == 0:
            return -1.0
        T = m.kf_pose[kf]
        pc = m.mp_pos[mps] @ T[:3, :3].T + T[:3, 3]
        return float(np.median(pc[:, 2]))

    # ------------------------------------------------------------------
    # SearchInNeighbors / Fuse (†LocalMapping::SearchInNeighbors)
    # ------------------------------------------------------------------
    def _fuse_neighbors(self, kf: int):
        """Same lock discipline as _create_new_points: gather under the map
        lock, one batched device dispatch without it, commit under it."""
        m = self.map
        sf = self.cfg.extractor.scale_factor
        with m.lock:
            epoch = m.correction_epoch
            neighbors = [int(x) for x in m.covisible_keyframes(kf, 10)]
            if not neighbors:
                return
            # project current KF's points into neighbors (and vice versa)
            directions = [(kf, nb) for nb in neighbors] + \
                [(nb, kf) for nb in neighbors]
            P = 1024
            D = 20  # fixed direction capacity (2 x 10 covisible neighbors)
            S = 11  # unique sources: current KF + up to 10 neighbors
            # so the batched kernel compiles once; padding rows pv False
            directions = directions[:D]
            srcs = [kf] + neighbors[: S - 1]
            src_index = {s: i for i, s in enumerate(srcs)}
            sel_u = np.zeros((S, P), np.int64)
            pv_u = np.zeros((S, P), bool)
            for si, src in enumerate(srcs):
                mps = m.kf_mp[src]
                mps = np.unique(mps[mps >= 0])
                mps = mps[m.mp_valid[mps]]
                if len(mps) > P:  # no silent caps: fuse recall shrinks here
                    print(f"[mapping] fuse from {src}: {len(mps) - P} "
                          f"points beyond the {P}-slot window skipped")
                sel_u[si, : min(len(mps), P)] = mps[:P]
                pv_u[si, : min(len(mps), P)] = True
            src_of_dir = np.zeros(D, np.int64)
            dst_d = np.zeros(D, np.int64)
            pv_dir_ok = np.zeros(D, bool)
            for di, (src, dst) in enumerate(directions):
                src_of_dir[di] = src_index[src]
                dst_d[di] = dst
                pv_dir_ok[di] = True
            sel_d = sel_u[src_of_dir]
            pv_d = pv_u[src_of_dir] & pv_dir_ok[:, None]
            mir = m.dev_kf.ensure(m)
            dev = self.device
            src = torch.from_numpy(src_of_dir).to(dev)
            dst = torch.from_numpy(dst_d).to(dev)
            args = (
                torch.from_numpy(m.mp_pos[sel_u]).to(dev)[src],
                torch.from_numpy(m.mp_desc[sel_u]).to(dev)[src],
                torch.from_numpy(pv_u).to(dev)[src],
                torch.from_numpy(m.kf_pose[dst_d]).to(dev),
                mir["kf_xy"][dst], mir["kf_desc"][dst], mir["kf_octave"][dst],
                mir["kf_feat_valid"][dst],
            )
        # one batched program for all 2N projection-fuse directions
        res_d = _fuse_match.fuse_match(*args, self.cam, float(np.float32(sf)), 3.0)
        rv_d = res_d.valid.cpu().numpy()
        ridx_d = res_d.idx.cpu().numpy()
        with m.lock:
            if m.correction_epoch != epoch:
                print("[mapping] discarding stale fuse matches "
                      "(correction landed mid-flight)")
                return
            self._fuse_commit(kf, neighbors, directions, sel_d, pv_d,
                              rv_d, ridx_d)

    def _fuse_commit(self, kf, neighbors, directions, sel_d, pv_d, rv_d,
                     ridx_d):
        m = self.map
        touched = set()
        for di, (src, dst) in enumerate(directions):
            if not m.kf_valid[dst]:
                continue  # culled while the kernel ran
            rv = rv_d[di]
            ridx = ridx_d[di]
            sel = sel_d[di]
            for row in np.where(rv & pv_d[di])[0]:
                mp = int(sel[row])
                if not m.mp_valid[mp]:
                    continue  # replaced away by an earlier fuse row
                feat = int(ridx[row])
                existing = int(m.kf_mp[dst, feat])
                if existing >= 0 and m.mp_valid[existing]:
                    if existing != mp:
                        # keep the better-observed point (†Fuse replace rule)
                        if m.mp_n_obs[existing] >= m.mp_n_obs[mp]:
                            m.replace_map_point(mp, existing)
                            touched.add(existing)
                        else:
                            m.replace_map_point(existing, mp)
                            touched.add(mp)
                else:
                    m.add_observation(mp, dst, feat)
                    touched.add(mp)
        if touched:
            self._attrs_pending.update(touched)
            m.update_connections(kf)
            for nb in neighbors:
                m.update_connections(nb)

    # ------------------------------------------------------------------
    # Local BA (gather window -> ops.ba -> write back)
    # ------------------------------------------------------------------
    def local_bundle_adjustment(self, kf: int):
        """Gather the window under the map lock, solve WITHOUT it (the LM
        chunks are the long device work), write back under it with
        liveness re-checked."""
        m = self.map
        with m.lock:
            epoch = m.correction_epoch
            gathered = self._local_ba_gather(kf)
        if gathered is None:
            return
        window, opt_mask_w, mp_ids, obs_valid, obs_src, prob = gathered
        res = self._local_ba_solve(prob)
        with m.lock:
            if m.correction_epoch != epoch:
                # the window was gathered pre-correction; writing the solved
                # poses back now would clobber the loop correction with
                # stale geometry (†RequestStop protocol analog)
                print("[mapping] discarding stale local-BA result "
                      "(correction landed mid-flight)")
                return
            self._local_ba_write_back(
                window, opt_mask_w, mp_ids, obs_valid, obs_src, res
            )

    def _local_ba_gather(self, kf: int):
        m = self.map
        rt = self.cfg.runtime
        local_kfs = [kf] + [int(x) for x in m.covisible_keyframes(kf)]
        local_kfs = local_kfs[: rt.local_ba_max_kfs]
        local_set = set(local_kfs)

        # points seen by local KFs
        mp_ids = np.unique(m.kf_mp[local_kfs])
        mp_ids = mp_ids[mp_ids >= 0]
        mp_ids = mp_ids[m.mp_valid[mp_ids]]
        if len(mp_ids) == 0 or len(local_kfs) < 2:
            return None
        mp_ids = mp_ids[: rt.local_ba_max_points]

        # fixed KFs: other observers of those points
        obs_kfs = m.mp_obs_kf[mp_ids]
        all_obs = np.unique(obs_kfs[obs_kfs >= 0])
        fixed_kfs = [int(x) for x in all_obs if int(x) not in local_set]
        fixed_kfs = fixed_kfs[: rt.local_ba_max_fixed_kfs]

        window = local_kfs + fixed_kfs
        # keyframe 0 is always held fixed (global gauge, †BundleAdjustment)
        opt = np.array(
            [(w in local_set) and (w != 0) for w in window], bool
        )
        if not opt.any():
            return None

        # window sizes padded to the reference's x4 buckets, so both packages
        # solve problems of the same shape
        def _bucket(n, lo, hi):
            b = lo
            while b < n and b < hi:
                b *= 4
            return min(b, hi)

        Kw = _bucket(len(window), 16, rt.local_ba_max_kfs
                     + rt.local_ba_max_fixed_kfs)
        Mw = _bucket(len(mp_ids), 1024, rt.local_ba_max_points)
        Ow = self.obs_cap
        poses = np.tile(np.eye(4, dtype=np.float32), (Kw, 1, 1))
        poses[: len(window)] = m.kf_pose[window]
        opt_mask = np.zeros(Kw, bool)
        opt_mask[: len(window)] = opt

        points = np.zeros((Mw, 3), np.float32)
        points[: len(mp_ids)] = m.mp_pos[mp_ids]
        point_valid = np.zeros(Mw, bool)
        point_valid[: len(mp_ids)] = True

        sf = self.cfg.extractor.scale_factor
        n_ids = len(mp_ids)
        # vectorized gather: map-level obs tables -> window-indexed obs tables
        w_of_kf = np.full(max(m.n_kf, 1), -1, np.int32)
        w_of_kf[np.asarray(window)] = np.arange(len(window), dtype=np.int32)
        raw_kf = m.mp_obs_kf[mp_ids]                       # (n, Omap)
        raw_ft = m.mp_obs_feat[mp_ids]
        wi = np.where(raw_kf >= 0, w_of_kf[np.maximum(raw_kf, 0)], -1)
        has = wi >= 0
        # compact valid slots to the front, keep first Ow
        order = np.argsort(~has, axis=1, kind="stable")[:, :Ow]
        rows = np.arange(n_ids)[:, None]
        wi_c = wi[rows, order]
        has_c = has[rows, order]
        kf_c = np.maximum(raw_kf[rows, order], 0)
        ft_c = np.maximum(raw_ft[rows, order], 0)

        obs_kf_t = np.full((Mw, Ow), -1, np.int32)
        obs_uvr = np.full((Mw, Ow, 3), -1.0, np.float32)
        obs_sigma2 = np.ones((Mw, Ow), np.float32)
        obs_valid = np.zeros((Mw, Ow), bool)
        obs_src = np.full((Mw, Ow, 2), -1, np.int64)
        obs_kf_t[:n_ids] = np.where(has_c, wi_c, -1)
        xy = m.kf_xy[kf_c, ft_c]                           # (n, Ow, 2)
        ur = m.kf_ur[kf_c, ft_c]
        obs_uvr[:n_ids] = np.concatenate([xy, ur[..., None]], axis=2)
        obs_sigma2[:n_ids] = sf ** (2.0 * m.kf_octave[kf_c, ft_c])
        obs_valid[:n_ids] = has_c
        obs_src[:n_ids, :, 0] = np.where(has_c, kf_c, -1)
        obs_src[:n_ids, :, 1] = np.where(has_c, ft_c, -1)

        dev = self.device
        prob = ba.BAProblem(*(torch.from_numpy(a).to(dev) for a in (
            poses, opt_mask, points, point_valid, obs_kf_t, obs_uvr,
            obs_sigma2, obs_valid)))
        return window, opt_mask, mp_ids, obs_valid, obs_src, prob

    def _local_ba_solve(self, prob):
        """The reference's chunked schedule: local_ba_iters LM iterations in
        chunks of 5, the outlier round after the last chunk. A waiting
        keyframe (``interrupt``) stops it between chunks with one more
        chunk and the outlier round, the reference's abbreviated finish."""
        rt = self.cfg.runtime
        chunk = 5
        done = 0
        res = None
        while done < rt.local_ba_iters:
            n = min(chunk, rt.local_ba_iters - done)
            last = done + n >= rt.local_ba_iters
            res = ba.optimize_ba(cam=self.cam, prob=prob, iters=n,
                                 outlier_rounds=1 if last else 0)
            prob = prob._replace(poses=res.poses, points=res.points)
            done += n
            if not last and self.interrupt():
                res = ba.optimize_ba(cam=self.cam, prob=prob, iters=chunk,
                                     outlier_rounds=1)
                break
        return res

    def _local_ba_write_back(self, window, opt_mask, mp_ids, obs_valid,
                             obs_src, res):
        # --- write back (the reference does this under mMutexMapUpdate);
        # liveness is re-checked: keyframes/points may have been culled
        # while the solver ran off-lock
        m = self.map
        new_poses = res.poses.cpu().numpy()
        for w, kfi in enumerate(window):
            if opt_mask[w] and m.kf_valid[kfi]:
                m.kf_pose[kfi] = new_poses[w]
        new_points = res.points.cpu().numpy()
        live = m.mp_valid[mp_ids]
        m.mp_pos[mp_ids[live]] = new_points[: len(mp_ids)][live]
        # outlier observation removal (only iterate actual violators)
        inl = res.obs_inlier.cpu().numpy()
        bad_i, bad_o = np.where(obs_valid & ~inl)
        for i, o in zip(bad_i, bad_o):
            mp = int(mp_ids[i])
            if not m.mp_valid[mp]:
                continue
            okf = int(obs_src[i, o, 0])
            m.erase_observation(mp, okf)
            if m.mp_n_obs[mp] <= 1:
                m.remove_map_point(mp)

    # ------------------------------------------------------------------
    # KeyFrameCulling (†LocalMapping::KeyFrameCulling)
    # ------------------------------------------------------------------
    def _cull_keyframes(self, kf: int):
        m = self.map
        for cand in [int(x) for x in m.covisible_keyframes(kf)]:
            if cand == 0 or not m.kf_valid[cand]:
                continue
            feats = np.where(m.kf_mp[cand] >= 0)[0]
            if len(feats) < 20:
                continue
            mps = m.kf_mp[cand, feats]
            live = m.mp_valid[mps]
            mps = mps[live]
            octs = m.kf_octave[cand, feats[live]]
            if len(mps) == 0:
                continue
            # vectorized: count other observers at same-or-finer (+1) scale
            okf = m.mp_obs_kf[mps]                        # (F, O)
            oft = np.maximum(m.mp_obs_feat[mps], 0)
            obs_oct = m.kf_octave[np.maximum(okf, 0), oft]
            counted = (okf >= 0) & (okf != cand) & (
                obs_oct <= (octs[:, None] + 1)
            )
            redundant = (counted.sum(1) >= 3).sum()
            if redundant > self.cfg.mapping.kf_cull_redundancy * len(feats):
                m.remove_keyframe(cand)
