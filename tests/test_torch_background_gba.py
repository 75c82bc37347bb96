"""tests/test_background_gba.py on the port: background, interruptible
global BA with staged write-back, on the reference's drifted circle
(``build_drifted_loop``, carried over with utils/convert.py), the kernels as
their plain versions. Keyframes inserted while GBA runs are corrected
through the spanning tree at write-back, the solver holds the map lock only
briefly (the reference's 0.5 s stall bound), and a newer GBA supersedes a
running one without corrupting the map."""

import time

import numpy as np
import torch

from test_loop_closing import build_drifted_loop
from test_torch_loop_closing import _port_closer

torch.set_num_threads(2)


def _reproj_med(m, kf, fx=300, fy=300, cx=160, cy=120):
    T = m.kf_pose[kf]
    feats = np.where(m.kf_mp[kf] >= 0)[0]
    mps = m.kf_mp[kf, feats]
    live = m.mp_valid[mps]
    feats, mps = feats[live], mps[live]
    pc = m.mp_pos[mps] @ T[:3, :3].T + T[:3, 3]
    z = np.maximum(pc[:, 2], 1e-6)
    u = fx * pc[:, 0] / z + cx
    v = fy * pc[:, 1] / z + cy
    return float(np.median(np.hypot(u - m.kf_xy[kf, feats, 0],
                                    v - m.kf_xy[kf, feats, 1])))


def _closer(rng):
    _, jm, _, _ = build_drifted_loop(rng)
    return _port_closer(jm)


def test_keyframes_inserted_during_gba(rng):
    lc = _closer(rng)
    m = lc.map
    lc.background_gba = True
    n_kf = len(m.valid_keyframes())
    closed = False
    for kf in range(n_kf):
        with m.lock:
            closed = lc.process_keyframe(kf, run_global_ba=True) or closed
    assert closed
    assert lc.gba_thread is not None

    # while GBA runs: keyframes the solver has never seen, each re-observing
    # the last keyframe's points from a nudged pose
    src = n_kf - 1
    new_kfs = []
    max_stall = 0.0
    for i in range(3):
        t0 = time.perf_counter()
        with m.lock:
            max_stall = max(max_stall, time.perf_counter() - t0)
            T = m.kf_pose[src].copy()
            T[0, 3] += 0.01 * (i + 1)
            kf = m.add_keyframe(
                T, m.kf_xy[src], m.kf_desc[src], m.kf_octave[src],
                m.kf_angle[src], m.kf_feat_valid[src],
                frame_id=1000 + i, timestamp=40.0 + i)
            for feat in np.where(m.kf_mp[src] >= 0)[0]:
                mp = int(m.kf_mp[src, feat])
                if m.mp_valid[mp]:
                    m.add_observation(mp, kf, int(feat))
            m.update_connections(kf)
        new_kfs.append(kf)
        time.sleep(0.02)

    assert lc.wait_global_ba(timeout=300.0)
    assert not lc.gba_thread.is_alive() and lc.gba_error is None
    assert max_stall < 0.5, max_stall  # the solve does not hold the lock

    for kf in m.valid_keyframes():
        assert np.isfinite(m.kf_pose[kf]).all()
    assert _reproj_med(m, 0) < 2.0
    assert _reproj_med(m, n_kf - 1) < 3.0
    for kf in new_kfs:
        e = _reproj_med(m, kf)
        assert e < 15.0, (kf, e)  # nudged pose: small but nonzero error


def test_newer_gba_supersedes(rng):
    lc = _closer(rng)
    m = lc.map
    n_kf = len(m.valid_keyframes())
    for kf in range(n_kf):
        with m.lock:
            lc.process_keyframe(kf, run_global_ba=False)
    pre = {int(k): m.kf_pose[k].copy() for k in m.valid_keyframes()}
    lc.background_gba = True
    lc.launch_global_ba_background()
    lc.launch_global_ba_background()  # supersede at once
    assert lc.wait_global_ba(timeout=300.0)
    assert lc.gba_error is None
    for kf in m.valid_keyframes():
        assert np.isfinite(m.kf_pose[kf]).all()
    # the second run completed and wrote back an actual optimization
    assert any(not np.allclose(pre[int(k)], m.kf_pose[k], atol=1e-7)
               for k in m.valid_keyframes())


def test_gba_failure_is_kept_for_the_caller(rng, monkeypatch):
    """A failing background GBA is reported and its exception kept in
    ``gba_error`` (the asynchronous system raises it on the caller's
    thread); the task's thread ends."""
    lc = _closer(rng)

    def fails(**kw):
        raise ValueError("injected failure")

    monkeypatch.setattr(lc, "global_bundle_adjustment", fails)
    lc.background_gba = True
    lc.launch_global_ba_background()
    assert lc.wait_global_ba(timeout=60.0)
    assert isinstance(lc.gba_error, ValueError)


def test_slots_freed_during_gba_wait_for_its_write_back(rng):
    """A point culled while global BA solves (by the mapping worker, which
    recycles freed slots once a keyframe cycle) stays pending until the
    write-back has run, so that the write-back cannot land on the slot of a
    new point; then the next cycle frees it. The reference recycles it at
    the next cycle, mid-solve (a named divergence)."""
    lc = _closer(rng)
    m = lc.map
    solve = lc._gba_solve
    seen = {}

    def solve_while_mapping(prob, iters):
        with m.lock:
            mp = int(m.valid_map_points()[0])
            m.remove_map_point(mp)
            m.recycle_free_slots()
            seen.update(mp=mp, free=mp in m.free_mp, holds=len(m.recycle_holds))
        return solve(prob, iters)

    lc._gba_solve = solve_while_mapping
    lc.global_bundle_adjustment()
    assert seen["holds"] == 1 and not seen["free"]
    assert not m.recycle_holds and not m.mp_valid[seen["mp"]]
    with m.lock:
        m.recycle_free_slots()
    assert seen["mp"] in m.free_mp
