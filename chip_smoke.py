"""Chip smoke test of the PyTorch + CUDA port (orbslam2_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing one line:
  1. the card: nvidia-smi name and power limit; exits non-zero without CUDA;
  2. builds the four CUDA kernels from orbslam2_tpu_torch/kernels/csrc;
  3. compares each kernel with its plain PyTorch version on the card at the
     main path's shapes (640x480, 8 levels, N=1024 keypoints, P=12288 local
     points, pose LM over 12288 edges of which ~600 valid) and times both
     with CUDA events;
  4. runs the port's SlamSystem (RGB-D, 640x480, 1000 features, 8 levels)
     over 36 rendered frames and checks it is never lost, makes >= 3
     keyframes, keeps ATE under 0.035 m, and launched every kernel.
Then the kernels as one JSON line, the card again, and as the last line
{"ok": true, "device": {...}}. Any failure raises and exits non-zero.
Imports nothing of JAX.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

W, H = 640, 480
FX = 520.0
ATE_BOUND = 0.035      # the reference e2e test's RGB-D bound (m)
N_FRAMES = 36


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=20, warmup=3):
    """Median milliseconds per call, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        sys.exit(2)
    # the port first: run outside a checkout, the script fails here before
    # printing anything
    from orbslam2_tpu_torch import kernels
    from orbslam2_tpu_torch.config import CameraConfig, ExtractorConfig, SlamConfig
    from orbslam2_tpu_torch.kernels import build, describe, fast_score, hamming, pose_lm
    from orbslam2_tpu_torch.models.camera import Camera
    from orbslam2_tpu_torch.ops import image as img_ops
    from orbslam2_tpu_torch.ops import orb
    from orbslam2_tpu_torch.system import SlamSystem
    from orbslam2_tpu_torch.tracking import TrackingState, predict_projection
    from orbslam2_tpu_torch.utils.evaluation import ate_rmse
    from orbslam2_tpu_torch.utils.synthetic import render_sequence

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda")

    # ---- phase 2: build ---------------------------------------------------
    t0 = time.perf_counter()
    build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build.build_seconds:.2f} s) -> {build.library_path()}")

    # ---- phase 3: kernels vs plain at main-path shapes --------------------
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1]], np.float32)
    frames, poses = render_sequence(N_FRAMES, K, width=W, height=H,
                                    with_depth=True)
    img0 = torch.from_numpy(frames[0][0].astype(np.float32)).to(dev)
    ext_cfg = ExtractorConfig(n_features=1000, n_levels=8)
    rows = []

    def record(mod, err, ms, plain_ms, note):
        rows.append(dict(name=mod.NAME, route="cuda", source=mod.SOURCE,
                         replaces=mod.REPLACES, max_abs_err=float(err),
                         ms=ms, plain_ms=plain_ms))
        print(f"kernel {mod.NAME}: {note}; {ms:.4f} ms vs plain {plain_ms:.4f} ms")

    # A: FAST score + NMS on the 640x480 level 0
    border = orb.PATCH_R
    raw_k, nms_k = fast_score.fast_score_nms(img0, border)
    raw_p, nms_p = fast_score.fast_score_nms_plain(img0, border)
    err_a = max((raw_k - raw_p).abs().max().item(),
                (nms_k - nms_p).abs().max().item())
    check(torch.equal(raw_k, raw_p) and torch.equal(nms_k, nms_p),
          f"kernel A not bit-exact (max err {err_a})")
    record(fast_score, err_a,
           cuda_ms(lambda: fast_score.fast_score_nms(img0, border)),
           cuda_ms(lambda: fast_score.fast_score_nms_plain(img0, border)),
           "bit-exact")

    # B: IC angle + BRIEF for the level-0 budget of keypoints
    budget0 = orb.level_budgets(1000, 8, 1.2)[0]
    xy_i, _, _, kv = orb.select_level(raw_k, nms_k, budget0, 20.0, 7.0)
    blurred = img_ops.gaussian_blur(img0)
    ang_k, desc_k = describe.orb_describe(img0, blurred, xy_i)
    ang_p, desc_p = describe.orb_describe_plain(img0, blurred, xy_i)
    d_ang = (ang_k - ang_p).abs()
    d_ang = torch.minimum(d_ang, 2 * np.pi - d_ang)[kv]
    bits_k = ((desc_k[kv, :, None] >> torch.arange(8, device=dev, dtype=torch.uint8)) & 1)
    bits_p = ((desc_p[kv, :, None] >> torch.arange(8, device=dev, dtype=torch.uint8)) & 1)
    bit_agree = (bits_k == bits_p).float().mean().item()
    err_b = d_ang.max().item()
    check(err_b <= 1e-3, f"kernel B angle error {err_b} > 1e-3 rad")
    check(bit_agree >= 0.995, f"kernel B descriptor bits agree {bit_agree} < 0.995")
    record(describe, err_b,
           cuda_ms(lambda: describe.orb_describe(img0, blurred, xy_i)),
           cuda_ms(lambda: describe.orb_describe_plain(img0, blurred, xy_i)),
           f"{int(kv.sum())} keypoints, angle max err {err_b:.2e} rad, "
           f"bits agree {bit_agree:.6f}")

    # C: gated Hamming top-2, P=12288 local points vs N=1024 keypoints.
    # The points are the frame's own keypoints back-projected with their
    # depth (about 1000, descriptors with a few flipped bits) plus random
    # points filling the buffer, projected from a slightly moved pose.
    extractor = orb.OrbExtractor(ext_cfg, H, W, device=dev)
    feats = extractor(img0)
    N = feats.xy.shape[0]
    P = 12288
    rng = np.random.default_rng(0)
    xy_np = feats.xy.cpu().numpy()
    depth0 = frames[0][1]
    d_kp = depth0[np.clip(np.round(xy_np[:, 1]).astype(int), 0, H - 1),
                  np.clip(np.round(xy_np[:, 0]).astype(int), 0, W - 1)]
    n_real = N
    pos = np.concatenate([rng.uniform(-2, 2, (P, 2)), rng.uniform(2, 6, (P, 1))], 1)
    pos[:n_real, 0] = (xy_np[:, 0] - W / 2) / FX * d_kp
    pos[:n_real, 1] = (xy_np[:, 1] - H / 2) / FX * d_kp
    pos[:n_real, 2] = d_kp
    desc_np = rng.integers(0, 256, (P, 32)).astype(np.uint8)
    flips = rng.integers(0, 256, (n_real, 32)).astype(np.uint8) & \
        rng.integers(0, 256, (n_real, 32)).astype(np.uint8) & \
        rng.integers(0, 256, (n_real, 32)).astype(np.uint8)
    desc_np[:n_real] = feats.desc.cpu().numpy() ^ flips
    mp_pos = torch.from_numpy(pos.astype(np.float32)).to(dev)
    mp_valid = torch.from_numpy(rng.random(P) < 0.9).to(dev)
    mp_valid[:n_real] = feats.valid
    mp_normal = torch.tensor([0.0, 0.0, 1.0], device=dev).expand(P, 3).contiguous()
    mp_dmin = torch.full((P,), 0.3, device=dev)
    mp_dmax = torch.from_numpy((pos[:, 2] * 1.2 ** 3).astype(np.float32)).to(dev)
    cam = Camera.create(FX, FX, W / 2, H / 2, bf=52.0, width=W, height=H)
    T_pred = torch.eye(4, device=dev)
    T_pred[0, 3] = 0.01
    proj, r_px, pred_level, ur_pred, frustum = predict_projection(
        cam, T_pred, mp_pos, mp_valid, mp_normal, mp_dmin, mp_dmax, 15.0, 1.2, 8)
    row_valid = mp_valid & frustum
    kp_ur = torch.where(feats.valid, feats.xy[:, 0] - 52.0 / 3.0,
                        torch.full_like(feats.xy[:, 0], -1.0))
    c_args = (torch.from_numpy(desc_np).to(dev), proj, r_px, pred_level,
              ur_pred, row_valid, feats.desc, feats.xy, feats.octave,
              feats.valid, kp_ur)
    out_k = hamming.hamming_top2_gated(*c_args)
    out_p = hamming.hamming_top2_gated_plain(*c_args)
    err_c = max((a.long() - b.long()).abs().max().item() for a, b in zip(out_k, out_p))
    check(all(torch.equal(a, b) for a, b in zip(out_k, out_p)),
          f"kernel C not bit-exact (max err {err_c})")
    n_rows = int(row_valid.sum())
    n_hit = int((out_k[1] <= 100).sum())
    record(hamming, err_c, cuda_ms(lambda: hamming.hamming_top2_gated(*c_args)),
           cuda_ms(lambda: hamming.hamming_top2_gated_plain(*c_args)),
           f"bit-exact; P={P} N={N}, {n_rows} rows in frustum, "
           f"{n_hit} with best <= TH_HIGH")

    # D: pose LM over 12288 edges, ~600 valid (10% gross outliers, half
    # of them stereo), from a perturbed start
    Pd = 12288
    n_val = 600
    pts = np.stack([rng.uniform(-3, 3, Pd), rng.uniform(-2, 2, Pd),
                    rng.uniform(2, 8, Pd)], 1).astype(np.float32)
    T_true = np.eye(4, dtype=np.float32)
    T_true[:3, 3] = [0.05, -0.02, 0.1]
    pc = pts @ T_true[:3, :3].T + T_true[:3, 3]
    u = FX * pc[:, 0] / pc[:, 2] + W / 2 + rng.normal(0, 0.7, Pd)
    v = FX * pc[:, 1] / pc[:, 2] + H / 2 + rng.normal(0, 0.7, Pd)
    ur = np.where(np.arange(Pd) % 2 == 0, u - 52.0 / pc[:, 2], -1.0)
    obs = np.stack([u, v, ur], 1).astype(np.float32)
    out_idx = rng.random(Pd) < 0.1
    obs[out_idx, :2] += rng.uniform(-40, 40, (int(out_idx.sum()), 2))
    octv = rng.integers(0, 8, Pd)
    sigma2 = (1.2 ** (2.0 * octv)).astype(np.float32)
    valid = np.zeros(Pd, bool)
    valid[rng.choice(Pd, n_val, replace=False)] = True
    T0 = np.eye(4, dtype=np.float32)
    d_args = (torch.from_numpy(T0).to(dev), cam, torch.from_numpy(pts).to(dev),
              torch.from_numpy(obs).to(dev), torch.from_numpy(sigma2).to(dev),
              torch.from_numpy(valid).to(dev))
    Tk, inl_k, n_k, _ = pose_lm.pose_lm(*d_args)
    Tp, inl_p, n_p, _ = pose_lm.pose_lm_plain(*d_args)
    err_d = (Tk - Tp).abs().max().item()
    dn = abs(int(n_k) - int(n_p))
    check(err_d <= 1e-4, f"kernel D pose differs by {err_d} > 1e-4")
    check(dn <= 0.005 * n_val, f"kernel D inliers {int(n_k)} vs {int(n_p)}")
    t_err = np.abs(Tk.cpu().numpy()[:3, 3] - T_true[:3, 3]).max()
    record(pose_lm, err_d, cuda_ms(lambda: pose_lm.pose_lm(*d_args)),
           cuda_ms(lambda: pose_lm.pose_lm_plain(*d_args), reps=5),
           f"pose max diff {err_d:.2e}, inliers {int(n_k)} vs {int(n_p)} "
           f"of {n_val}, translation error vs truth {t_err:.2e} m")

    # ---- hot path: extraction + fused cascade per frame --------------------
    # (the reference bench's hot-path definition) against kernel C's local
    # map, each frame ending in the tracker's one D2H copy of the result
    from orbslam2_tpu_torch.tracking import track_frame_fused

    imgs = [torch.from_numpy(f[0].astype(np.float32)).to(dev) for f in frames]
    mp_args = (mp_pos, c_args[0], mp_valid, mp_normal, mp_dmin, mp_dmax)
    no_depth = torch.full((N,), -1.0, device=dev)

    def hot(img):
        f = extractor(img)
        return track_frame_fused(cam, T_pred, *mp_args, f.xy, f.desc, f.octave,
                                 f.valid, no_depth, no_depth, 35.0, 15.0, 1.2,
                                 8, 30).cpu()

    hot(imgs[0])
    torch.cuda.synchronize()
    t_hot = time.perf_counter()
    for img in imgs:
        hot(img)
    t_hot = time.perf_counter() - t_hot
    print(f"hot path: {len(imgs) / t_hot:.2f} frames/s (extraction + fused "
          f"cascade, 640x480, N={N}, P={P})")

    # ---- phase 4: the slice ------------------------------------------------
    cfg = SlamConfig(
        sensor="rgbd",
        camera=CameraConfig(fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W,
                            height=H, bf=52.0, fps=30),
        extractor=ExtractorConfig(n_features=1000, n_levels=8),
    )
    slam = SlamSystem(cfg, device=dev)
    kernels.reset_launches()
    est, gt, times = [], [], []
    for i, ((img, depth), Tcw_true) in enumerate(zip(frames, poses)):
        t1 = time.perf_counter()
        pose = slam.track_rgbd(img, depth, i / 30.0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        check(pose is not None, f"frame {i}: tracking lost")
        est.append(np.linalg.inv(pose)[:3, 3])
        gt.append(np.linalg.inv(Tcw_true)[:3, 3])
    counts = kernels.launch_counts()
    n_kf = len(slam.map.valid_keyframes())
    ate = ate_rmse(np.array(est), np.array(gt), with_scale=False)
    fps_all = len(times) / sum(times)
    fps_steady = (len(times) - 1) / sum(times[1:])
    print(f"slice: {len(times)} frames, never lost, {n_kf} keyframes, "
          f"{len(slam.map.valid_map_points())} points, ATE {ate:.5f} m, "
          f"{fps_all:.2f} frames/s ({fps_steady:.2f} after the first frame), "
          f"launches {counts}")
    check(slam.tracking_state == TrackingState.OK, "final state not OK")
    check(n_kf >= 3, f"only {n_kf} keyframes")
    check(ate < ATE_BOUND, f"ATE {ate} >= {ATE_BOUND}")
    for name, n in counts.items():
        check(n > 0, f"kernel {name} never launched on the main path")
    for row in rows:
        row["launches"] = counts[row["name"]]

    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
