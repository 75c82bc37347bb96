"""The port's copies of ``tests/test_obs_growth.py``: a point observed by
more keyframes than the initial per-point slot allocation keeps every
observation (the table doubles up to its ceiling), and a grown table
survives the checkpoint round trip. The reference's assertions unchanged."""

import numpy as np

from orbslam2_tpu_torch.config import CameraConfig, ExtractorConfig, SlamConfig
from orbslam2_tpu_torch.map.state import MapState


def _cfg():
    cfg = SlamConfig(
        sensor="rgbd",
        camera=CameraConfig(fx=260, fy=260, cx=160, cy=120, width=320,
                            height=240, bf=26.0, fps=30),
        extractor=ExtractorConfig(n_features=200, n_levels=4),
    )
    cfg.capacity.max_obs_per_point = 4  # tiny so growth triggers fast
    return cfg


def _insert_kf(m, rng, pose_tx=0.0):
    N = m.kf_xy.shape[1]
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = pose_tx
    return m.add_keyframe(
        T, rng.uniform(0, 320, (N, 2)).astype(np.float32),
        rng.integers(0, 256, (N, 32)).astype(np.uint8),
        np.zeros(N, np.int32), np.zeros(N, np.float32),
        np.ones(N, bool), 0, 0.0,
    )


def test_batch_growth_keeps_all_observations():
    rng = np.random.default_rng(0)
    m = MapState.allocate(_cfg(), device="cpu")
    mps = m.add_map_points_batch(
        np.tile(np.float32([0, 0, 5.0]), (8, 1)), ref_kf=0
    )
    n_kfs = 20  # 5x the initial 4-slot table
    for i in range(n_kfs):
        kf = _insert_kf(m, rng, pose_tx=0.01 * i)
        m.add_observations_batch(mps, kf, np.arange(len(mps)))
    assert m.mp_obs_kf.shape[1] >= n_kfs
    assert m.obs_drops == 0
    assert (m.mp_n_obs[mps] == n_kfs).all()
    # every (kf, feat) binding present and mutually consistent
    for p in mps:
        kfs = m.mp_obs_kf[p][m.mp_obs_kf[p] >= 0]
        assert len(kfs) == n_kfs and len(set(kfs.tolist())) == n_kfs


def test_scalar_growth_and_ceiling():
    rng = np.random.default_rng(1)
    m = MapState.allocate(_cfg(), device="cpu")
    m.OBS_SLOT_LIMIT = 8  # exercise the hard ceiling
    mps = m.add_map_points_batch(np.float32([[0, 0, 5.0]]), ref_kf=0)
    p = int(mps[0])
    for i in range(12):
        kf = _insert_kf(m, rng, pose_tx=0.01 * i)
        m.add_observation(p, kf, i)
    assert m.mp_obs_kf.shape[1] == 8   # grew 4 -> 8, then hit the ceiling
    assert m.mp_n_obs[p] == 8
    assert m.obs_drops == 4            # ceiling drops are counted, not silent


def test_checkpoint_roundtrip_with_grown_table(tmp_path):
    rng = np.random.default_rng(2)
    cfg = _cfg()
    m = MapState.allocate(cfg, device="cpu")
    mps = m.add_map_points_batch(
        np.tile(np.float32([0, 0, 5.0]), (4, 1)), ref_kf=0
    )
    for i in range(10):
        kf = _insert_kf(m, rng, pose_tx=0.01 * i)
        m.add_observations_batch(mps, kf, np.arange(len(mps)))
    assert m.mp_obs_kf.shape[1] > cfg.capacity.max_obs_per_point

    from orbslam2_tpu_torch.utils.checkpoint import load_map, save_map

    path = str(tmp_path / "grown.npz")
    save_map(path, m)
    m2 = load_map(path, cfg, device="cpu")  # config still allocates the small table
    assert m2.mp_obs_kf.shape == m.mp_obs_kf.shape
    assert (m2.mp_obs_kf == m.mp_obs_kf).all()
    assert (m2.mp_n_obs == m.mp_n_obs).all()
