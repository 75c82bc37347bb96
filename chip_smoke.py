"""Chip smoke test of the PyTorch + CUDA port (orbslam2_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing one line:
  1. the card: nvidia-smi name and power limit; exits non-zero without CUDA;
  2. builds the CUDA kernels from orbslam2_tpu_torch/kernels/csrc (one nvcc
     per source, in parallel);
  3. compares each kernel with its plain PyTorch version on the card at the
     main path's shapes (640x480, 8 levels, N=1024 keypoints, P=12288 local
     points, pose LM over 12288 edges of which ~600 valid; bundle adjustment
     steps E-H on the local-BA window K=16, M=1024, O=8); times one call
     of each kernel's wrapper and of its plain version between CUDA
     events, and the kernel alone on the device (torch.profiler's device
     events), and computes its bound from the run's inputs; then the whole
     BA schedule, kernels against the plain schedule
     (utils/ba_parity.compare), at K=16/M=1024/O=8 (5 iterations + outlier
     round, the local mapper's last chunk) and at the reference bench's
     K=64/M=4096/O=8 (10 iterations + outlier round);
  4. runs the port's SlamSystem (RGB-D, 640x480, 1000 features, 8 levels)
     over 36 rendered frames and checks it is never lost, makes >= 3
     keyframes, keeps ATE under 0.035 m, and launched every kernel.
Then the kernels as one JSON line (times, launches on the slice, the bound
from this run's inputs), the card again, and as the last line
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
# H100 SXM peaks (NVIDIA's data sheet, at 700 W): HBM bytes/s and float32
# operations/s outside the tensor cores; every kernel here is float32 or
# integer work on the CUDA cores
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12


def bound(n_bytes, n_ops):
    """(ms, "bytes" | "operations"): the least time the card could take."""
    t_b, t_o = n_bytes / PEAK_BYTES, n_ops / PEAK_OPS
    return (1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations")


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


def device_ms(fn, kernel, reps=20):
    """Mean device time in ms of the CUDA kernel named ``kernel`` over
    ``reps`` calls of ``fn`` (torch.profiler's device events), each call
    launching it once; with ``kernel=None``, of all device events."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and (kernel is None or kernel in e.key)]
    if kernel is not None:
        count = sum(e.count for e in events)
        check(count == reps, f"{kernel}: {count} device events for {reps} calls")
    return sum(e.self_device_time_total for e in events) / reps / 1e3


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def describe_footprint(xy, angle, width, height):
    """Distinct pixels kernel B reads at keypoints ``xy`` (n, 2) with their
    angles: of the level, the radius-15 circles (729 pixels, rows to
    round(sqrt(15^2 - dy^2))); of the blurred level, the 512 test points
    rotated and rounded; both clamped to the image as the kernel clamps."""
    from orbslam2_tpu_torch.utils.convert import brief_pattern

    dev = xy.device
    d = torch.arange(-15, 16, device=dev)
    umax = torch.round(torch.sqrt((225 - d * d).float()))
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    inside = dx.abs() <= umax[:, None]
    circle = torch.stack([dx[inside], dy[inside]], 1)            # (729, 2)
    pa, pb = brief_pattern()
    pat = torch.from_numpy(np.concatenate([pa, pb])).float().to(dev)
    c, s = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
    tests = torch.stack([torch.round(pat[:, 0] * c - pat[:, 1] * s),
                         torch.round(pat[:, 0] * s + pat[:, 1] * c)], -1)

    def distinct(p):
        x = p[..., 0].long().clamp(0, width - 1)
        y = p[..., 1].long().clamp(0, height - 1)
        return int(torch.unique(y * width + x).numel())

    xy = xy.long()
    return distinct(xy[:, None] + circle) + distinct(xy[:, None] + tests.long())


def ba_rows(dev, record):
    """Kernels E-H one step each against their plain versions on the first
    LM iteration of the local-BA window (K=16, M=1024, O=8), then the whole
    schedule against the plain schedule at both shapes."""
    from orbslam2_tpu_torch.kernels import (ba_accept, ba_linearize, ba_solve,
                                            ba_update_cost)
    from orbslam2_tpu_torch.models.camera import Camera
    from orbslam2_tpu_torch.ops import ba
    from orbslam2_tpu_torch.utils import ba_parity
    from orbslam2_tpu_torch.utils.synthetic import ba_window

    cam = Camera.create(FX, FX, W / 2, H / 2, bf=52.0, width=W, height=H)

    def problem(K, M):
        return ba.BAProblem(*(torch.from_numpy(a).to(dev)
                              for a in ba_window(K, M, 8, seed=K)))

    def rel_err(a, b):
        """max |a - b| over max |b| (sums in another order, float atomics)"""
        return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()

    def point_err(a, b):
        """largest point difference relative to the point's distance"""
        return ((a - b).norm(dim=1) / b.norm(dim=1).clamp_min(1e-6)).max().item()

    prob = problem(16, 1024)
    K, M, O = 16, 1024, 8
    lam = torch.full((1,), 1e-4, device=dev)
    obs = (prob.point_valid, prob.obs_kf, prob.obs_uvr, prob.obs_sigma2)
    mask = ba_linearize.effective_mask(prob.obs_kf, prob.obs_valid, prob.point_valid)
    n_obs = int(mask.sum())
    n_pairs = int((mask.sum(1) ** 2).sum())
    n_kf = int((prob.obs_kf >= 0).sum())

    # E: linearisation and the reduced camera system
    e_args = (cam, prob.poses, prob.points, *obs, prob.obs_valid, lam, True)
    lin_k = ba_linearize.ba_linearize(*e_args)
    lin_p = ba_linearize.ba_linearize_plain(*e_args)
    errs = [rel_err(a, b) for a, b in zip(lin_k, lin_p)]
    check(max(errs) <= 1e-4, f"kernel E relative errors {errs} > 1e-4")
    record(ba_linearize, (lin_k.S - lin_p.S).abs().max().item(),
           lambda: ba_linearize.ba_linearize(*e_args),
           cuda_ms(lambda: ba_linearize.ba_linearize_plain(*e_args)),
           f"K={K} M={M} O={O}, {n_obs} observations, {n_pairs} pairs; "
           f"relative errors (S, b_S, E, Dinv, b_l) "
           + ", ".join(f"{e:.1e}" for e in errs),
           # inputs read once; S, b_S, E, Dinv, b_l written; per observation
           # projection, Jacobians, weight, its H and b, E, D, b_l, E D^-1
           # and its b_S term (~680 ops), per ordered pair of a landmark's
           # observations a 6x6 block of 3-term dot products and its atomic
           # add (216), per landmark the damped adjugate inverse (~60)
           n_bytes=nbytes(prob.poses, prob.points, *obs, prob.obs_valid, lam,
                          *lin_k),
           n_ops=680 * n_obs + 216 * n_pairs + 60 * M)

    # F: Cholesky solve and pose step, both fed the kernel's system
    f_args = (lin_k.S, lin_k.b_S, prob.opt_mask, lam, prob.poses)
    dc_k, pn_k = ba_solve.ba_solve(*f_args)
    dc_p, pn_p = ba_solve.ba_solve_plain(*f_args)
    err_f = (pn_k - pn_p).abs().max().item()
    check(err_f <= 1e-4, f"kernel F poses differ by {err_f} > 1e-4")
    n = 6 * K
    record(ba_solve, err_f, lambda: ba_solve.ba_solve(*f_args),
           cuda_ms(lambda: ba_solve.ba_solve_plain(*f_args)),
           f"6K={n}; trial poses max diff {err_f:.2e}, steps max diff "
           f"{(dc_k - dc_p).abs().max().item():.2e}",
           # S, b_S, masks and poses read once, steps and poses written;
           # n^3/3 multiply-adds of the Cholesky, two triangular solves,
           # the symmetrisation, ~200 ops per camera for se3_exp(dc) @ T
           n_bytes=nbytes(*f_args, dc_k, pn_k),
           n_ops=2 * n ** 3 // 3 + 2 * n * n + n * n + 200 * K)

    # G: back-substitution and trial cost, fed the kernels' step
    step = (dc_k, lin_k.E, lin_k.Dinv, lin_k.b_l)
    g_args = (cam, pn_k, prob.points, *obs, prob.obs_valid, prob.obs_valid, True,
              step)
    pts_k, cost_k, inl_k = ba_update_cost.ba_update_cost(*g_args)
    pts_p, cost_p, inl_p = ba_update_cost.ba_update_cost_plain(*g_args)
    err_g = (pts_k - pts_p).abs().max().item()
    rel_g = point_err(pts_k, pts_p)
    d_cost = abs(cost_k.item() - cost_p.item()) / abs(cost_p.item())
    flips = (inl_k != inl_p).float().mean().item()
    check(rel_g <= 1e-4, f"kernel G points differ by {rel_g} relative")
    check(d_cost <= 1e-4 and flips <= 1e-3,
          f"kernel G cost rel diff {d_cost}, inlier flips {flips}")
    record(ba_update_cost, err_g,
           lambda: ba_update_cost.ba_update_cost(*g_args),
           cuda_ms(lambda: ba_update_cost.ba_update_cost_plain(*g_args)),
           f"points max diff {err_g:.2e}, cost rel diff {d_cost:.1e}, "
           f"inlier flips {flips:.1e}",
           # inputs read once, points, cost and inliers written; per
           # observation with a camera E^T dc (33 ops), projection, chi2 and
           # rho (~42); per landmark the 3x3 back-substitution (~21)
           n_bytes=nbytes(pn_k, prob.points, *obs, prob.obs_valid,
                          prob.obs_valid, *step, pts_k, cost_k, inl_k),
           n_ops=75 * n_kf + 21 * M)

    # H: accept / reject, in place on copies of the state
    def h_state():
        return (cost_k, pn_k, pts_k, torch.full((1,), 1e9, device=dev),
                lam.clone(), prob.poses.clone(), prob.points.clone())
    st_k, st_p = h_state(), h_state()
    ba_accept.ba_accept(*st_k)
    ba_accept.ba_accept_plain(*st_p)
    err_h = max((a - b).abs().max().item() for a, b in zip(st_k[3:], st_p[3:]))
    check(err_h == 0.0, f"kernel H state differs by {err_h}")
    st_t = h_state()
    record(ba_accept, err_h, lambda: ba_accept.ba_accept(*st_t),
           cuda_ms(lambda: ba_accept.ba_accept_plain(*st_t)),
           "state exact (accepted step)",
           # the costs, lambda, both poses and both points read once, cost,
           # lambda, poses and points written; one compare and two selects
           n_bytes=nbytes(*st_t) + nbytes(*st_t[3:]), n_ops=3)

    # the whole schedule, kernels against the plain schedule: float atomics
    # in S and sums in another order, held to ba_parity.LIMITS (poses 1e-4,
    # points 1e-4 of their distance where the inliers constrain them,
    # every point's reprojections 1e-2 px, 0.1% inlier flips, cost 1e-3)
    for K, M, iters in ba_parity.SHAPES:
        prob = problem(K, M)
        rk = ba.optimize_ba(cam, prob, iters=iters, outlier_rounds=1)
        rp = ba.optimize_ba_plain(cam, prob, iters=iters, outlier_rounds=1)
        got = ba_parity.compare(cam, prob, rk, rp)
        moved = (rk.poses - prob.poses).abs().max().item()
        check(not ba_parity.over_limits(got) and moved > 1e-3,
              f"BA K={K} M={M}: {got}, moved {moved}")
        ms_k = cuda_ms(lambda: ba.optimize_ba(cam, prob, iters=iters,
                                              outlier_rounds=1), reps=10)
        dev_k = device_ms(lambda: ba.optimize_ba(cam, prob, iters=iters,
                                                 outlier_rounds=1), None, reps=5)
        ms_p = cuda_ms(lambda: ba.optimize_ba_plain(cam, prob, iters=iters,
                                                    outlier_rounds=1),
                       reps=3, warmup=1)
        print(f"ba K={K} M={M} O=8 iters={iters}+outlier round: kernels "
              f"{ms_k:.3f} ms ({dev_k:.3f} ms on the device) vs plain "
              f"{ms_p:.3f} ms; poses max diff {got['poses']:.2e}, points rel "
              f"{got['points']:.2e} ({got['points_all']:.2e} with the "
              f"{got['loose']} loose ones), reprojection {got['reproj']:.2e} "
              f"px, inlier flips {got['flips']:.1e}, cost "
              f"{rk.cost.item():.3f} vs {rp.cost.item():.3f}")


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

    def record(mod, err, fn, plain_ms, note, n_bytes, n_ops):
        """One kernel's row: ms is one wrapper call between CUDA events
        (host work included), device_ms the kernel's own device time,
        plain_ms the plain version's call between CUDA events."""
        ms = cuda_ms(fn)
        dev_ms = device_ms(fn, mod.FUNCTION)
        bound_ms, bound_by = bound(n_bytes, n_ops)
        rows.append(dict(name=mod.NAME, route="cuda", source=mod.SOURCE,
                         replaces=mod.REPLACES, max_abs_err=float(err),
                         ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
        print(f"kernel {mod.NAME}: {note}; {ms:.4f} ms a call (device "
              f"{dev_ms:.4f} ms) vs plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.6f} ms ({bound_by})")

    # A: FAST score + NMS on the 640x480 level 0
    border = orb.PATCH_R
    raw_k, nms_k = fast_score.fast_score_nms(img0, border)
    raw_p, nms_p = fast_score.fast_score_nms_plain(img0, border)
    err_a = max((raw_k - raw_p).abs().max().item(),
                (nms_k - nms_p).abs().max().item())
    check(torch.equal(raw_k, raw_p) and torch.equal(nms_k, nms_p),
          f"kernel A not bit-exact (max err {err_a})")
    record(fast_score, err_a,
           lambda: fast_score.fast_score_nms(img0, border),
           cuda_ms(lambda: fast_score.fast_score_nms_plain(img0, border)),
           "bit-exact",
           # the level read once, two score maps written; per pixel 16 ring
           # differences, two arc-min doublings over 16 (4 x 16 min each),
           # two 16-way max, the sign flips, the border test and 9-way NMS
           n_bytes=3 * 4 * H * W, n_ops=(16 + 2 * (64 + 16) + 16 + 1 + 12) * H * W)

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
           lambda: describe.orb_describe(img0, blurred, xy_i),
           cuda_ms(lambda: describe.orb_describe_plain(img0, blurred, xy_i)),
           f"{int(kv.sum())} keypoints, angle max err {err_b:.2e} rad, "
           f"bits agree {bit_agree:.6f}",
           # read once: the pixels under the keypoints' circles and rotated
           # tests (describe_footprint), the pattern and the keypoints; angle
           # and 32 bytes written; per keypoint 2 MACs over the circle,
           # then 256 rotated, rounded and compared pairs (~12 ops each)
           n_bytes=4 * describe_footprint(xy_i, ang_k, W, H)
           + 4 * 2 * 512 + xy_i.numel() * 4 + xy_i.shape[0] * (4 + 32),
           n_ops=xy_i.shape[0] * (2 * 2 * 729 + 256 * 12))

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
    # work of this run's data: the gate (~10 ops) for every valid row and
    # valid keypoint, the 256-bit distance (8 xor, 8 popc, 7 adds) and the
    # top-2 update (~4) for the pairs inside the search radius
    d2 = ((proj[row_valid][:, None, :] - feats.xy[None]) ** 2).sum(-1)
    in_r = (d2 <= (r_px[row_valid] ** 2)[:, None]) & feats.valid[None]
    c_ops = 10 * n_rows * int(feats.valid.sum()) + 27 * int(in_r.sum())
    c_bytes = sum(t.numel() * t.element_size() for t in c_args) + 4 * 4 * P
    record(hamming, err_c, lambda: hamming.hamming_top2_gated(*c_args),
           cuda_ms(lambda: hamming.hamming_top2_gated_plain(*c_args)),
           f"bit-exact; P={P} N={N}, {n_rows} rows in frustum, "
           f"{n_hit} with best <= TH_HIGH", n_bytes=c_bytes, n_ops=c_ops)

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
    record(pose_lm, err_d, lambda: pose_lm.pose_lm(*d_args),
           cuda_ms(lambda: pose_lm.pose_lm_plain(*d_args), reps=5),
           f"pose max diff {err_d:.2e}, inliers {int(n_k)} vs {int(n_p)} "
           f"of {n_val}, translation error vs truth {t_err:.2e} m",
           # inputs read once (pose, points, observations, sigma2, valid),
           # pose, inliers, count and chi2 written; per LM iteration over the
           # valid edges: evaluation + Jacobian (~90 ops), the 27 entries of
           # H and b (~160), the trial cost (~40); per round a chi2 pass over
           # all edges (~40)
           n_bytes=64 + Pd * (12 + 12 + 4 + 1) + 64 + 4 + Pd * (1 + 4),
           n_ops=4 * 10 * n_val * (90 + 160 + 40) + 4 * Pd * 40)

    ba_rows(dev, record)

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
