"""Chip smoke test of the PyTorch + CUDA port (orbslam2_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing one line:
  1. the card: nvidia-smi name and power limit; exits non-zero without CUDA;
  2. builds the CUDA kernels from orbslam2_tpu_torch/kernels/csrc (one nvcc
     per source, in parallel);
  3. compares each kernel with its plain PyTorch version on the card at the
     main path's shapes (640x480, 8 levels, N=1024 keypoints, P=12288 local
     points, pose LM over 12288 edges of which ~600 valid; triangulation
     against B=10 neighbours and fuse over D=20 directions of P=1024 points
     on keyframes from rendered frames; bundle adjustment steps E-H on the
     local-BA window K=16, M=1024, O=8); times one call of each kernel's
     wrapper and of its plain version between CUDA events, and the kernel
     alone on the device (torch.profiler's device events; a profile that
     missed launches is taken again, and if all three do, the mean of the
     recorded launches counts), and computes its bound from the run's
     inputs. Then: the tracking cascade (kernels O, C, Q, D, R) against the
     plain cascade, from a prediction the first pass tracks and from one
     only the device-side retry tracks, and, by profiler, that one frame's
     cascade runs no device work but its kernels, memsets and the
     prediction's upload, with exactly one device-to-host copy; the whole
     BA schedule, kernels against the plain schedule
     (utils/ba_parity.compare), at K=16/M=1024/O=8 (5 iterations + outlier
     round, the local mapper's last chunk) and at the reference bench's
     K=64/M=4096/O=8 (10 iterations + outlier round), with kernel F beside
     the library's Cholesky solve of the same system; the front end's
     kernels I (every level of the pyramid) and J (the selection on every
     level) bit-exact, L bit-exact with and without distortion, N on
     seeded batches at P=512, O=8, 32 and 64; and, by profiler, that the
     extraction from a host image runs no device work but I, A, J, B, a
     buffer fill and the upload;
  4. runs the port's SlamSystem (RGB-D, 640x480, 1000 features, 8 levels)
     over 36 rendered frames and checks it is never lost, makes >= 3
     keyframes and keeps ATE under 0.035 m;
  5. the stereo path: SlamSystem.track_stereo over 30 rendered KITTI-width
     pairs (examples/settings/KITTI00-02.yaml: 1241x376, 2000 features)
     at the reference e2e test's bounds (tracked >= frames - 1,
     ATE < 0.045 m, share of keyframe features with u_right above 0.3, >= 3
     keyframes) with kernels V and W on every frame; the fallback path: the
     last stereo frame through Tracker._track_reference_keyframe with kernel
     U and with its plain matcher, the match sets equal and the poses within
     1e-4; the monocular path: SlamSystem.track_monocular over 50 rendered
     TUM-width frames (examples/settings/TUM1.yaml's camera without
     distortion, 1000 features) at the reference's bounds (>= 25 tracked,
     ATE with scale < 0.035 m, final state OK), kernels U and X launched by
     the initialisation. Each path's launch counts are set to 0 just before
     it and read just after, and each path must launch the kernels PATHS
     names; then U (N=2048 at the fallback, N=1024 windowed), V and W
     (N=2048, 376x1241; W on the frame quantized to 8 bits, and within
     1e-3 px on the float render) bit-exact and X (N=1024) within tolerance
     against their plain versions on the arguments the paths gave them.
Then the kernels as one JSON line (times, launches summed over the paths,
the bound from this run's inputs), the card again, and as the last line
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
# the reference e2e tests' stereo and monocular bounds
STEREO_ATE = 0.045     # m, without scale
STEREO_SHARE = 0.3     # keyframe features with a measured u_right
MONO_ATE = 0.035       # m, with scale
MONO_TRACKED = 25      # frames with a pose, of 50

# the kernels (NAME) each path must launch
FRONT = ("pyramid_level", "fast_score_nms", "orb_select", "orb_describe")
CASCADE = ("project_gate", "hamming_top2_gated", "claim_resolve", "pose_lm",
           "cascade_pack")
MAPPING = ("triangulate", "fuse_match", "point_attrs", "ba_linearize",
           "ba_solve", "ba_update_cost", "ba_accept")
PATHS = {
    "rgbd": FRONT + ("rgbd_depth",) + CASCADE + MAPPING,
    "stereo": FRONT + ("stereo_match", "stereo_sad") + CASCADE + MAPPING,
    "mono": FRONT + ("match_rot", "two_view") + CASCADE + MAPPING,
    "fallback": ("match_rot",) + CASCADE,
}
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


profile_retries = []   # (kernel, events seen, launches) of discarded profiles
profile_gaps = {}      # kernel: (events seen, launches) where every profile missed some


def device_events(fn, kernel, reps=20):
    """(device ms, events) of the CUDA kernels whose name holds ``kernel``
    (every device event with ``kernel=None``) over ``reps`` calls of
    ``fn``, from torch.profiler's device events. For a named kernel, other
    launches (an add of one float) come before and after the calls inside
    the profile, so that events the profiler drops at its edges are not
    the kernel's."""
    fn()
    torch.cuda.synchronize()
    pad = torch.zeros(1, device="cuda")

    def margin():
        if kernel is not None:
            for _ in range(8):
                pad.add_(1.0)
            torch.cuda.synchronize()

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        margin()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        margin()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and (kernel is None or kernel in e.key)]
    return (sum(e.self_device_time_total for e in events) / 1e3,
            sum(e.count for e in events))


def device_ms(fn, kernel, reps=20, per_call=1, attempts=3):
    """Device time in ms per call of ``fn`` of the CUDA kernel named
    ``kernel`` over ``reps`` calls, each launching it ``per_call`` times
    (with ``kernel=None``, of all device events). A profile that saw every
    one of the kernel's launches gives the sum over the calls; one that
    missed any is recorded in ``profile_retries`` and taken again,
    ``attempts`` times at most. If every profile missed launches, the mean
    time of the launches the fullest one recorded, times ``per_call``, and
    the kernel's (events, launches) in ``profile_gaps``."""
    best = (0.0, 0)
    for _ in range(attempts):
        total, count = device_events(fn, kernel, reps)
        if kernel is None or count == reps * per_call:
            return total / reps
        profile_retries.append((kernel, count, reps * per_call))
        best = max(best, (total, count), key=lambda tc: tc[1])
    check(best[1] > 0, f"{kernel}: no device event in {attempts} profiles")
    profile_gaps[kernel] = (best[1], reps * per_call)
    return best[0] / best[1] * per_call


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


MP_KEYS = ("pos", "desc", "valid", "normal", "dmin", "dmax")
RETRY_YAW = 0.05  # rad off in the prediction: the first pass admits < 10 inliers


def yawed(T, yaw):
    """T with its rotation replaced by ``yaw`` rad about the y axis."""
    c, s = float(np.cos(yaw)), float(np.sin(yaw))
    out = T.clone()
    out[:3, :3] = torch.tensor([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]],
                               device=T.device)
    return out


def local_map_case(feats, depth, rng, P=12288):
    """A local map of P points for the frame's keypoints ``feats``: the
    keypoints back-projected with their ``depth`` (descriptors with a few
    flipped bits), then random points from ``rng`` filling the buffer; and
    the depth at each keypoint."""
    dev = feats.xy.device
    N = feats.xy.shape[0]
    xy_np = feats.xy.cpu().numpy()
    d_kp = depth[np.clip(np.round(xy_np[:, 1]).astype(int), 0, H - 1),
                 np.clip(np.round(xy_np[:, 0]).astype(int), 0, W - 1)]
    pos = np.concatenate([rng.uniform(-2, 2, (P, 2)), rng.uniform(2, 6, (P, 1))], 1)
    pos[:N, 0] = (xy_np[:, 0] - W / 2) / FX * d_kp
    pos[:N, 1] = (xy_np[:, 1] - H / 2) / FX * d_kp
    pos[:N, 2] = d_kp
    desc = rng.integers(0, 256, (P, 32)).astype(np.uint8)
    flips = rng.integers(0, 256, (N, 32)).astype(np.uint8) & \
        rng.integers(0, 256, (N, 32)).astype(np.uint8) & \
        rng.integers(0, 256, (N, 32)).astype(np.uint8)
    desc[:N] = feats.desc.cpu().numpy() ^ flips
    valid = torch.from_numpy(rng.random(P) < 0.9).to(dev)
    valid[:N] = feats.valid
    return dict(pos=torch.from_numpy(pos.astype(np.float32)).to(dev),
                desc=torch.from_numpy(desc).to(dev), valid=valid,
                normal=torch.tensor([0.0, 0.0, 1.0], device=dev).expand(P, 3).contiguous(),
                dmin=torch.full((P,), 0.3, device=dev),
                dmax=torch.from_numpy((pos[:, 2] * 1.2 ** 3).astype(np.float32)).to(dev)
                ), d_kp


def cascade_case(cam, local_map, feats, d_kp):
    """The cascade's arguments after the prediction, at the main path's
    shapes: phase 3's P=12288 local map and frame 0's N keypoints with their
    depth and u_right."""
    dev = feats.xy.device
    d = torch.from_numpy(np.asarray(d_kp, np.float32)).to(dev)
    depth = torch.where(feats.valid & (d > 0), d, torch.full_like(d, -1.0))
    ur = torch.where(depth > 0, feats.xy[:, 0] - torch.full_like(d, cam.bf)
                     / depth.clamp_min(1e-6), torch.full_like(d, -1.0))
    return tuple(local_map[k] for k in MP_KEYS) + (
        feats.xy, feats.desc, feats.octave, feats.valid, ur, depth)


def census_depth(args):
    """The median keypoint depth of a cascade case: a close/far split that
    puts keypoints on both sides (the slice's ThDepth of 3.5 m lies below
    most of frame 0's depths)."""
    d = args[-1]
    return float(d[d > 0].median())


def first_pass_inliers(cam, T_pred, args):
    """Pass 1's inlier count of the cascade from ``T_pred`` (plain)."""
    from orbslam2_tpu_torch import tracking
    from orbslam2_tpu_torch.kernels import pose_lm

    _, cl = tracking.project_match(tracking._PLAIN, cam, T_pred, *args[:11],
                                   15.0, 1.2, 8)
    return int(pose_lm.pose_lm_plain(T_pred, cam, args[0], cl.obs, cl.sigma2,
                                     cl.keep)[2])


def cascade_kernels(run):
    """The kinds of device work of one ``run()`` of a tracked frame's
    cascade, from the prediction's upload to the packed result on the host
    (torch.profiler's device events); fails unless each is a kernel of the
    cascade (O, C, Q, D, R), a memset or the upload, and unless exactly one
    copy goes to the host."""
    from orbslam2_tpu_torch.kernels import (cascade_pack, claim_resolve, hamming,
                                            pose_lm, project_gate)

    run()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    counts = {e.key: e.count for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA}
    allowed = [m.FUNCTION for m in (project_gate, hamming, claim_resolve, pose_lm,
                                    cascade_pack)] + ["Memset", "Memcpy HtoD"]
    d2h = sum(n for k, n in counts.items() if "DtoH" in k)
    other = sorted(k for k in counts
                   if "DtoH" not in k and not any(a in k for a in allowed))
    check(not other, f"the cascade launched other device work: {other}")
    check(d2h == 1, f"the cascade made {d2h} device-to-host copies, not 1")
    return sum(counts.values()), sorted(counts)


def cascade_rows(dev, record, cam, local_map, feats, d_kp, T_pred):
    """Kernels O, Q and R against their plain versions at the main path's
    shapes (P=12288 local points, N=1024 keypoints), then the whole cascade
    (kernels O, C, Q, D, R) against the plain cascade on the card from a
    prediction the first pass tracks and from one it cannot (the retry),
    and the profiler check of one frame's cascade."""
    from orbslam2_tpu_torch import tracking
    from orbslam2_tpu_torch.kernels import (cascade_pack, claim_resolve, hamming,
                                            pose_lm, project_gate)

    args = cascade_case(cam, local_map, feats, d_kp)
    th_depth = census_depth(args)
    mp_pos, mp_desc, mp_valid, mp_normal, mp_dmin, mp_dmax = args[:6]
    kp_xy, kp_desc, kp_octave, kp_valid, kp_ur, kp_depth = args[6:]
    P, N = mp_pos.shape[0], kp_xy.shape[0]

    # O: every output bit-exact but pred_level, whose log() may round apart
    o_args = (cam, T_pred, mp_pos, mp_valid, mp_normal, mp_dmin, mp_dmax, 15.0,
              1.2, 8)
    ok_, op_ = project_gate.project_gate(*o_args), project_gate.project_gate_plain(*o_args)
    lvl_same = ok_.pred_level == op_.pred_level
    agree = lvl_same.float().mean().item()
    check(torch.equal(ok_.proj, op_.proj) and torch.equal(ok_.ur_pred, op_.ur_pred)
          and torch.equal(ok_.row_valid, op_.row_valid)
          and torch.equal(ok_.r_px[lvl_same], op_.r_px[lvl_same]),
          "kernel O not bit-exact")
    check(agree >= 0.999, f"kernel O pred_level agrees for {agree} < 0.999")
    err_o = (ok_.r_px - op_.r_px).abs().max().item()
    n_rows = int(ok_.row_valid.sum())
    record(project_gate, err_o, lambda: project_gate.project_gate(*o_args),
           cuda_ms(lambda: project_gate.project_gate_plain(*o_args)),
           f"P={P}, {n_rows} in the frustum; projection, u_right, frustum "
           f"bit-exact, pred_level equal for {100 * agree:.4f}% of points",
           # the pose and, per point, position, validity, normal and depth
           # band read once, kernel C's five inputs written; ~70 ops a point
           n_bytes=64 + 4 * 8 + P * (12 + 1 + 12 + 4 + 4) + P * (8 + 4 + 4 + 4 + 1),
           n_ops=70 * P)

    # Q: fed kernel C's output on kernel O's projection; bit-exact
    top2 = hamming.hamming_top2_gated(mp_desc, *ok_[:4], ok_.row_valid, kp_desc,
                                      kp_xy, kp_octave, kp_valid, kp_ur)
    q_args = (*top2, ok_.row_valid, kp_xy, kp_octave, kp_ur, 1.2, 100, 0.9)
    qk = claim_resolve.claim_resolve(*q_args)
    qp = claim_resolve.claim_resolve_plain(*q_args)
    check(all(torch.equal(a, b) for a, b in zip(qk, qp)),
          "kernel Q claims, keep, observations or sigma^2 differ")
    ok_rows = int(((top2[1] <= 100) & ok_.row_valid).sum())
    record(claim_resolve, 0.0, lambda: claim_resolve.claim_resolve(*q_args),
           cuda_ms(lambda: claim_resolve.claim_resolve_plain(*q_args)),
           f"{ok_rows} rows within TH_HIGH, {int(qk.keep.sum())} kept; claims, "
           f"keep, observations and sigma^2 bit-exact",
           # C's four outputs and the frustum mask read once, the keypoints'
           # xy, u_right and octave, the sigma^2 table; kp_of_mp, keep, obs
           # and sigma^2 written; ~12 ops a point
           n_bytes=P * (16 + 1) + N * (8 + 4 + 4) + 4 * 32 + P * (4 + 1 + 12 + 4),
           n_ops=12 * P, per_call=2)

    # R: fed the kernels' local-map and tight passes; bit-exact
    def pass_(Tcw, r):
        pr, cl = tracking.project_match(tracking._KERNELS, cam, Tcw, *args[:11],
                                        r, 1.2, 8)
        T, inl, n, _ = pose_lm.pose_lm(Tcw, cam, mp_pos, cl.obs, cl.sigma2, cl.keep)
        return T, n, inl, cl.kp_of_mp, pr.row_valid

    T2, n2, inl2, kp2, fr2 = pass_(T_pred, 4.0)
    T3, n3, inl3, kp3, _ = pass_(T2, 2.0)
    r_args = (T2, n2, inl2, kp2, T3, n3, inl3, kp3, n2, fr2, kp_valid, kp_depth,
              th_depth)
    rk = cascade_pack.cascade_pack(*r_args)
    rp = cascade_pack.cascade_pack_plain(*r_args)
    check(torch.equal(rk, rp), "kernel R's packed vector differs")
    record(cascade_pack, 0.0, lambda: cascade_pack.cascade_pack(*r_args),
           cuda_ms(lambda: cascade_pack.cascade_pack_plain(*r_args)),
           f"packed vector bit-exact (n2 {int(n2)}, n3 {int(n3)}, census "
           f"{int(rk[18])} / {int(rk[19])})",
           # both passes' pose, count, inliers and claims, the frustum mask,
           # the keypoints' validity and depth read once, (20 + P) floats
           # written; ~10 ops a point and 5 a keypoint
           n_bytes=2 * (64 + 4 + P * 5) + 4 + P + N * 5 + 4 * (20 + P),
           n_ops=10 * P + 5 * N)

    # the whole cascade against the plain cascade, both retry branches:
    # pose 1e-4 (kernel D sums in another order), counts and codes >= 99%
    # equal, as tests/test_torch_tracking.py holds the plain cascade to JAX
    for label, Tp, retry in (("tracked", T_pred, False),
                             ("retry", yawed(T_pred, RETRY_YAW), True)):
        n1 = first_pass_inliers(cam, Tp, args)
        check((n1 < 10) == retry, f"cascade {label}: pass 1 has {n1} inliers")
        fused = (cam, Tp, *args, th_depth, 15.0, 1.2, 8, 10)
        pk = tracking.track_frame_fused(*fused)
        pp = tracking.track_frame_fused(*fused, plain=True)
        err = (pk[:16] - pp[:16]).abs().max().item()
        counts_ok = all(abs(pk[i].item() - pp[i].item()) <= max(0.01 * pp[i].item(), 1)
                        for i in range(16, 20))
        codes = (pk[20:] == pp[20:]).float().mean().item()
        check(err <= 1e-4 and counts_ok and codes >= 0.99 and pp[17] > 100,
              f"cascade {label}: pose {err}, counts {pk[16:20].tolist()} vs "
              f"{pp[16:20].tolist()}, codes {codes}")
        ms_k = cuda_ms(lambda: tracking.track_frame_fused(*fused).cpu())
        dev_k = device_ms(lambda: tracking.track_frame_fused(*fused), None, reps=10)
        ms_p = cuda_ms(lambda: tracking.track_frame_fused(*fused, plain=True).cpu(),
                       reps=5, warmup=1)
        print(f"cascade {label}: pass 1 {n1} inliers; kernels {ms_k:.3f} ms a frame "
              f"({dev_k:.3f} ms on the device) vs plain {ms_p:.3f} ms; pose max "
              f"diff {err:.2e}, counts {[int(v) for v in pk[16:20].tolist()]} vs "
              f"{[int(v) for v in pp[16:20].tolist()]}, codes equal {codes:.5f}")
    T_np = T_pred.cpu().numpy()
    n_ev, kinds = cascade_kernels(lambda: tracking.track_frame_fused(
        cam, torch.from_numpy(T_np).to(dev), *args, th_depth, 15.0, 1.2, 8,
        10).cpu())
    print(f"cascade on the card, all its device work: {n_ev} events, one "
          f"device-to-host copy: " + ", ".join(kinds))


def mapping_case(dev, cam, extractor, frames, poses):
    """Local mapping's kernel inputs at the main path's shapes from rendered
    frames 0, 3, ..., 30 as keyframes (their features, N = 1024 slots; the
    depth at each keypoint and u_right; the true poses). Fuse: D = 20
    directions, frame 30's points into the 10 others and theirs into it,
    P = 1024 points each (the keypoints with depth, unprojected). Triangulation:
    frame 30 against the 10 others (B = 10, the last a padding row), half of
    its keypoints already holding a point."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    kfs = []
    for i in range(0, 31, 3):
        img, depth = frames[i]
        f = extractor(img)
        xy, valid = f.xy.cpu().numpy(), f.valid.cpu().numpy()
        d = depth[np.clip(np.rint(xy[:, 1]).astype(int), 0, H - 1),
                  np.clip(np.rint(xy[:, 0]).astype(int), 0, W - 1)].astype(np.float32)
        d = np.where(valid & (d > 0), d, -1.0).astype(np.float32)
        ur = np.where(d > 0, xy[:, 0] - cam.bf / np.maximum(d, 1e-6), -1.0)
        kfs.append(dict(xy=f.xy, desc=f.desc, oct=f.octave, valid=f.valid,
                        depth=t(d), ur=t(ur.astype(np.float32)),
                        T=t(poses[i].astype(np.float32)), xy_np=xy, d_np=d))
    cur, nbs = kfs[-1], kfs[:-1]
    N, P = cur["xy"].shape[0], 1024

    def points(kf):
        ok = np.where(kf["d_np"] > 0)[0][:P]
        x, d = kf["xy_np"][ok], kf["d_np"][ok][:, None]
        pc = np.concatenate([(x[:, :1] - cam.cx) / cam.fx * d,
                             (x[:, 1:] - cam.cy) / cam.fy * d, d], 1)
        Twc = np.linalg.inv(kf["T"].cpu().numpy())
        pos = np.zeros((P, 3), np.float32)
        pos[:len(ok)] = pc @ Twc[:3, :3].T + Twc[:3, 3]
        desc = torch.zeros((P, 32), dtype=torch.uint8, device=dev)
        desc[:len(ok)] = kf["desc"][t(ok)]
        valid = np.zeros(P, bool)
        valid[:len(ok)] = True
        return t(pos), desc, t(valid)

    dirs = [(cur, nb) for nb in nbs] + [(nb, cur) for nb in nbs]
    src = [points(a) for a, _ in dirs]
    stack = lambda key: torch.stack([b[key] for _, b in dirs])  # noqa: E731
    fuse_args = (torch.stack([s[0] for s in src]), torch.stack([s[1] for s in src]),
                 torch.stack([s[2] for s in src]), stack("T"), stack("xy"),
                 stack("desc"), stack("oct"), stack("valid"), cam, 1.2, 3.0)
    avail1 = cur["valid"] & (torch.arange(N, device=dev) % 2 == 0)
    nb_ok = torch.ones(len(nbs), dtype=torch.bool, device=dev)
    nb_ok[-1] = False
    nstack = lambda key: torch.stack([nb[key] for nb in nbs])  # noqa: E731
    tri_args = (cur["desc"], cur["xy"], cur["oct"], avail1, cur["depth"], cur["ur"],
                cur["T"], nstack("desc"), nstack("xy"), nstack("oct"), nstack("valid"),
                nstack("depth"), nstack("ur"), nstack("T"), nb_ok, t(cam.K),
                cam.bf / cam.fx, cam.bf, 1.2)
    return fuse_args, tri_args


def mapping_rows(dev, record, cam, extractor, frames, poses):
    """Kernels S (triangulation, B = 10, N = 1024) and T (fuse, D = 20,
    P = N = 1024) against their plain versions on keyframes from rendered
    frames."""
    from orbslam2_tpu_torch.kernels import fuse_match, scale, triangulate
    from orbslam2_tpu_torch.ops import matching

    fuse_args, tri_args = mapping_case(dev, cam, extractor, frames, poses)

    # S: idx exact; good flips <= max(2, 1%) and X within 1e-4 m where both
    # keep the point (the geometry runs in the plain version's order, so
    # it may well be bit-exact, which the line reports)
    Xk, gk, ik = triangulate.triangulate(*tri_args)
    Xp, gp, ip = triangulate.triangulate_plain(*tri_args)
    n_good = int(gp.sum())
    flips = int((gk != gp).sum())
    both = gk & gp
    err_s = (Xk - Xp)[both].abs().max().item() if both.any() else 0.0
    exact = torch.equal(Xk, Xp) and torch.equal(gk, gp)
    check(torch.equal(ik, ip), "kernel S match indices differ")
    check(n_good > 50 and flips <= max(2, 0.01 * n_good),
          f"kernel S: {n_good} good, {flips} flips")
    check(err_s <= 1e-4, f"kernel S points differ by {err_s} m")
    desc1, xy1, oct1, avail1 = tri_args[:4]
    xy2, oct2, avail2, T2, K = tri_args[8], tri_args[9], tri_args[10], tri_args[13], tri_args[15]
    B, N = xy2.shape[:2]
    F21 = matching.fundamental_from_poses(K, K, tri_args[6], T2)
    pair = matching.epipolar_gate(xy1.expand(B, N, 2), xy2, F21,
                                  scale.table(1.2, "sig2", dev)[oct2.long()])
    pair = pair & avail1[None, :, None] & avail2[:, None, :]
    n_pairs, n_match = int(pair.sum()), int((ik >= 0).sum())
    n_gate = int(avail1.sum()) * N * B
    record(triangulate, err_s, lambda: triangulate.triangulate(*tri_args),
           cuda_ms(lambda: triangulate.triangulate_plain(*tri_args)),
           f"B={B} N={N}: {n_pairs} pairs in the epipolar band, {n_match} "
           f"mutual matches, {n_good} good; idx exact, good flips {flips}, X "
           f"max diff {err_s:.2e} m; X and good bit-exact: {exact}",
           # the keyframes' arrays, poses, F21, projections and K read once,
           # X, good and idx written; per available row and neighbour keypoint
           # the epipolar gate (8 ops), per admitted pair the distance, the
           # top-2 and the column atomic (28), per match the DLT, ray and
           # gate geometry (~800)
           n_bytes=nbytes(*(a for a in tri_args if torch.is_tensor(a)), F21)
           + 4 * 12 * (B + 1) + B * N * (12 + 1 + 4),
           n_ops=8 * n_gate + 28 * n_pairs + 800 * n_match, per_call=2)

    # T: idx, dist and valid bit-exact
    rk = fuse_match.fuse_match(*fuse_args)
    rp = fuse_match.fuse_match_plain(*fuse_args)
    check(all(torch.equal(a, b) for a, b in zip(rk, rp)),
          f"kernel T differs: valid flips {int((rk.valid != rp.valid).sum())}")
    rows, fpair = fuse_match.fuse_pairs(*(fuse_args[i] for i in (0, 2, 3, 4, 6)),
                                        cam, 1.2, 3.0)
    fpair = fpair & rows[..., None] & fuse_args[7][:, None, :]
    D, P = fuse_args[0].shape[:2]
    n_fp = int(fpair.sum())
    record(fuse_match, 0.0, lambda: fuse_match.fuse_match(*fuse_args),
           cuda_ms(lambda: fuse_match.fuse_match_plain(*fuse_args)),
           f"D={D} P={P} N={fuse_args[4].shape[1]}: {int(rows.sum())} points in "
           f"view, {n_fp} pairs in the radius, {int(rk.valid.sum())} matches; "
           f"bit-exact",
           # the windows, poses and keyframes read once, idx, dist and valid
           # written; per point in view and keypoint the gate (6 ops), per
           # admitted pair the distance and the min (26)
           n_bytes=nbytes(*fuse_args[:8]) + 4 * 32 + D * P * 9,
           n_ops=6 * int(rows.sum()) * fuse_args[4].shape[1] + 26 * n_fp)


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

    def library_solve(lin, prob, lam):
        """ms of the library's Cholesky and triangular solves of kernel F's
        damped 6K x 6K system (timed only; the port never calls them)"""
        Sd, b_S, _ = ba_solve.damped_system(lin.S, lin.b_S, prob.opt_mask, lam)
        return cuda_ms(lambda: torch.cholesky_solve(
            b_S[:, None], torch.linalg.cholesky(Sd)))

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
           f"{(dc_k - dc_p).abs().max().item():.2e}; library: "
           f"torch.linalg.cholesky + torch.cholesky_solve of the damped system",
           library_ms=library_solve(lin_k, prob, lam),
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
        lin = ba_linearize.ba_linearize(cam, prob.poses, prob.points, prob.point_valid,
                                        prob.obs_kf, prob.obs_uvr, prob.obs_sigma2,
                                        prob.obs_valid, lam, True)
        f_lib = library_solve(lin, prob, lam)
        f_ms = cuda_ms(lambda: ba_solve.ba_solve(lin.S, lin.b_S, prob.opt_mask, lam,
                                                 prob.poses))
        print(f"ba K={K} M={M} O=8 iters={iters}+outlier round: kernels "
              f"{ms_k:.3f} ms ({dev_k:.3f} ms on the device) vs plain "
              f"{ms_p:.3f} ms; poses max diff {got['poses']:.2e}, points rel "
              f"{got['points']:.2e} ({got['points_all']:.2e} with the "
              f"{got['loose']} loose ones), reprojection {got['reproj']:.2e} "
              f"px, inlier flips {got['flips']:.1e}, cost "
              f"{rk.cost.item():.3f} vs {rp.cost.item():.3f}; kernel F "
              f"{f_ms:.4f} ms vs library Cholesky solve {f_lib:.4f} ms "
              f"(6K={6 * K})")


def extraction_kernels(extractor, frame):
    """The kinds of device work of one ``extractor(frame)`` call from a host
    image (torch.profiler's device events); fails unless each is a kernel
    of the extraction path (I, A, J, B), the fill of the frame's zeroed
    feature buffer, or the image's upload and float conversion."""
    from orbslam2_tpu_torch.kernels import describe, fast_score, orb_select, pyramid

    extractor(frame)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        extractor(frame)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA}
    allowed = [m.FUNCTION for m in (pyramid, fast_score, orb_select, describe)] \
        + ["FillFunctor", "copy", "Memcpy HtoD", "Memset"]
    other = sorted(n for n in names if not any(a in n for a in allowed))
    check(not other, f"extraction launched other device work: {other}")
    return sorted({a for n in names for a in allowed if a in n})


def front_rows(dev, record, img0, depth0, feats, cam):
    """Kernels I, J, L and N against their plain versions at the main path's
    shapes: the 8-level pyramid of the 640x480 frame, the selection on every
    level, the depth sampling of the frame's N=1024 keypoints (with and
    without distortion), and a seeded point-attribute batch at P=512, O=8,
    32 and 64."""
    import torch.nn.functional as F

    from orbslam2_tpu_torch.kernels import (fast_score, orb_select, point_attrs,
                                            pyramid, rgbd_depth)
    from orbslam2_tpu_torch.models.camera import Camera
    from orbslam2_tpu_torch.ops import image as img_ops
    from orbslam2_tpu_torch.ops import orb

    # I: every level from the previous one (level 0: the blur alone),
    # level and blur bit-exact
    shapes = img_ops.pyramid_shapes(H, W, 8, 1.2)
    args = [None] + shapes[1:]
    levels, prev = [], img0
    for shape in args:
        lk, bk = pyramid.pyramid_level(prev, shape)
        lp, bp = pyramid.pyramid_level_plain(prev, shape)
        check(torch.equal(lk, lp) and torch.equal(bk, bp),
              f"kernel I not bit-exact at {tuple(lk.shape)}: level "
              f"{(lk - lp).abs().max().item()}, blur {(bk - bp).abs().max().item()}")
        levels.append(lk)
        prev = lk

    def chain(step):
        prev = img0
        for shape in args:
            prev = step(prev, shape)[0]

    taps = torch.from_numpy(pyramid.gaussian_kernel1d())
    k2d = (taps[:, None] * taps[None, :]).to(dev)[None, None]

    def library_level(prev, shape):
        level = prev if shape is None else F.interpolate(
            prev[None, None], size=shape, mode="bilinear", align_corners=False)[0, 0]
        return level, F.conv2d(F.pad(level[None, None], (3, 3, 3, 3), mode="reflect"),
                               k2d)[0, 0]

    torch.backends.cudnn.allow_tf32 = False
    lib_i = cuda_ms(lambda: chain(library_level))
    px_in = sum(a * b for a, b in [(H, W)] + shapes[:-1])
    px_out = sum(a * b for a, b in shapes)
    record(pyramid, 0.0, lambda: chain(pyramid.pyramid_level),
           cuda_ms(lambda: chain(pyramid.pyramid_level_plain)),
           "8 levels 640x480 -> 179x134, levels and blurs bit-exact; library: "
           "F.interpolate bilinear + a 7x7 F.conv2d (no TF32), which rounds "
           "differently (one 2-D pass, cuDNN's order)",
           # each source level read once, levels 1-7 and 8 blurs written;
           # per output pixel two 2-tap passes (6 ops, the rows pass over the
           # source width) and 2 x 7 taps of the blur (28)
           n_bytes=4 * (px_in + (px_out - H * W) + px_out),
           n_ops=34 * px_out, library_ms=lib_i, per_call=8)

    # J: the selection on every level from kernel A's maps, written into
    # feature buffers at the level's offset as the extractor does; every
    # slot bit-exact, invalid ones included
    budgets = orb.level_budgets(1000, 8, 1.2)
    maps = [fast_score.fast_score_nms(lv, orb.PATCH_R) for lv in levels]
    n_tot = sum(budgets)

    def select(kernel):
        f = orb.empty_features(n_tot, dev)
        xy_i, s = [], 0
        for lvl, ((raw, nms), n) in enumerate(zip(maps, budgets)):
            sl = slice(s, s + n)
            sel = orb_select.Selection(f.xy[sl], f.response[sl], f.octave[sl], f.valid[sl])
            if kernel:
                xy_i.append(orb_select.orb_select(raw, nms, n, 20.0, 7.0, 1.2 ** lvl,
                                                  lvl, out=sel)[0])
            else:
                xi, xs, r, v = orb_select.orb_select_plain(raw, nms, n, 20.0, 7.0)
                sel.xy.copy_(xs * float(1.2 ** lvl))
                sel.response.copy_(r)
                sel.octave.fill_(lvl)
                sel.valid.copy_(v)
                xy_i.append(xi)
            s += n
        return torch.cat(xy_i), f

    xk, fk = select(True)
    xp, fp = select(False)
    same = torch.equal(xk, xp) and all(torch.equal(a, b) for a, b in zip(fk, fp))
    err_j = (fk.xy - fp.xy).abs().max().item()
    check(same, f"kernel J not bit-exact (xy max err {err_j})")
    n_valid = int(fk.valid.sum())
    keys = sum(orb_select.n_keys(*lv.shape) for lv in levels)
    # the raw score map is read only at each slot's parabola taps: count
    # the distinct pixels, clamped as the kernel clamps them
    taps = torch.tensor([[0, 0], [0, -1], [0, 1], [-1, 0], [1, 0]], device=dev)
    raw_px, s = 0, 0
    for lv, n in zip(levels, budgets):
        h, w = lv.shape
        y = xk[s:s + n, 1:2].clamp(1, h - 2) + taps[:, 0]       # (n, 5)
        x = xk[s:s + n, 0:1].clamp(1, w - 2) + taps[:, 1]
        raw_px += int(torch.unique(y * w + x).numel())
        s += n
    record(orb_select, err_j, lambda: select(True),
           cuda_ms(lambda: select(False)),
           f"8 levels, {n_tot} slots ({n_valid} valid), {keys} keys, every slot "
           f"bit-exact",
           # the NMS map read once, the raw map at the distinct parabola
           # taps, the slots written (xy_int, xy, response, octave, valid);
           # per pixel the cell max, threshold and 8 rounds of
           # compare-select (19 ops); per key the bitonic sort's
           # log2(n)(log2(n)+1)/2 compare-exchanges
           n_bytes=4 * px_out + 4 * raw_px + 25 * n_tot,
           n_ops=19 * px_out + sum(
               k * int(np.log2(k)) * (int(np.log2(k)) + 1) // 2
               for k in (1 << int(np.ceil(np.log2(orb_select.n_keys(*lv.shape))))
                         for lv in levels)),
           per_call=8)

    # L: the frame's keypoints on the stride-2 uint16 depth upload
    d = depth0[::2, ::2]
    d_u16 = np.where((d > 0) & (d * 1e3 < 65535.0), d * 1e3, 0.0).astype(np.uint16)
    depth_q = torch.from_numpy(d_u16).to(dev)
    n = feats.xy.shape[0]
    cam_d = Camera.create(FX, FX, W / 2, H / 2, k1=-0.12, k2=0.03, p1=0.001,
                          p2=-0.0008, k3=0.01, bf=52.0, width=W, height=H)
    l_args = (depth_q, 1e-3, feats.xy, feats.valid)
    err_l = 0.0
    for c in (cam, cam_d):
        out_k = rgbd_depth.rgbd_depth(*l_args, c, stride=2)
        out_p = rgbd_depth.rgbd_depth_plain(*l_args, c, stride=2)
        err_l = max([err_l] + [(a - b).abs().max().item() for a, b in zip(out_k, out_p)])
        check(all(torch.equal(a, b) for a, b in zip(out_k, out_p)),
              f"kernel L not bit-exact (distortion {c.has_distortion}, err {err_l})")
    n_depth = int((out_k[2] > 0).sum())
    record(rgbd_depth, err_l, lambda: rgbd_depth.rgbd_depth(*l_args, cam, stride=2),
           cuda_ms(lambda: rgbd_depth.rgbd_depth_plain(*l_args, cam, stride=2)),
           f"N={n}, {n_depth} with depth, bit-exact with and without distortion "
           f"(timed without, as the slice's camera)",
           # keypoints and validity read, one u16 depth per keypoint, u_r and
           # depth written; ~12 ops a keypoint without distortion
           n_bytes=n * (8 + 1 + 2 + 4 + 4), n_ops=12 * n)

    # N: seeded batches over a 64-keyframe mirror of 1024 features
    rng = np.random.default_rng(5)
    Kf, Nf, P = 64, 1024, 512
    kf_desc = torch.from_numpy(rng.integers(0, 256, (Kf, Nf, 32)).astype(np.uint8)).to(dev)
    kf_oct = torch.from_numpy(rng.integers(0, 8, (Kf, Nf)).astype(np.int32)).to(dev)
    poses = np.tile(np.eye(4, dtype=np.float32), (Kf, 1, 1))
    poses[:, :3, 3] = rng.normal(0, 0.5, (Kf, 3))
    kf_pose = torch.from_numpy(poses).to(dev)

    def batch(O):
        """Kernel N's arguments at P points and O slots, and the batch's
        (live observations, sum of n_obs^2, distinct keyframes, distinct
        (keyframe, feature) pairs)."""
        n_obs = rng.integers(1, O + 1, P)
        obs_kf = np.full((P, O), -1, np.int16)
        obs_ft = np.full((P, O), -1, np.int16)
        for p in range(P):
            obs_kf[p, :n_obs[p]] = rng.choice(Kf, n_obs[p], replace=False)
            obs_ft[p, :n_obs[p]] = rng.integers(0, Nf, n_obs[p])
        pos = rng.uniform(-3, 3, (P, 3)).astype(np.float32) + np.float32([0, 0, 5])
        ref = np.where(rng.random(P) < 0.8, obs_kf[:, 0], -1).astype(np.int32)
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        live = obs_kf >= 0
        pairs = obs_kf[live].astype(np.int64) * Nf + obs_ft[live]
        return (kf_desc, kf_oct, kf_pose, t(obs_kf), t(obs_ft), t(pos), t(ref),
                1.2, 7.0), (int(n_obs.sum()), int((n_obs ** 2).sum()),
                            len(np.unique(obs_kf[live])), len(np.unique(pairs)))

    err_n = 0.0
    for O in (8, 32, 64):
        n_args, n_work = batch(O)
        ok = point_attrs.point_attributes(*n_args)
        op = point_attrs.point_attributes_plain(*n_args)
        check(torch.equal(ok[:, :32], op[:, :32]) and torch.equal(ok[:, 37], op[:, 37]),
              f"kernel N descriptors or ref_kf differ at O={O}")
        e = ((ok[:, 32:37] - op[:, 32:37]).abs()
             / op[:, 32:37].abs().clamp_min(1.0)).max().item()
        check(e <= 1e-5, f"kernel N normals / band differ by {e} at O={O}")
        err_n = max(err_n, (ok - op).abs().max().item())
        if O == 8:
            args8, (live8, pairs8, kfs8, descs8) = n_args, n_work
    record(point_attrs, err_n, lambda: point_attrs.point_attributes(*args8),
           cuda_ms(lambda: point_attrs.point_attributes_plain(*args8)),
           f"P={P}, O=8 ({live8} observations), 32 and 64: descriptors and ref_kf "
           f"exact, normals and band within 1e-5 (timed at O=8)",
           # the slots read, each distinct (keyframe, feature) descriptor and
           # each distinct keyframe's R and t once, one octave per point
           # (its band's slot), the points read once, (P, 38) written; per
           # ordered pair of live slots 8 xor + popc + add (24 ops) and the
           # median's compare and count (2), ~40 ops per live slot for the
           # normal
           n_bytes=P * 8 * 4 + descs8 * 32 + kfs8 * 48 + P * (4 + 12 + 4 + 38 * 4),
           n_ops=26 * pairs8 + 40 * live8)


class Capture:
    """Within ``with``, records the arguments and the result of the last
    call of ``module.fn`` (with ``when``, of the last call ``when(args,
    kwargs)`` admits); the call runs unchanged, or through ``use`` in its
    place."""

    def __init__(self, module, fn, when=None, use=None):
        self.module, self.fn, self.when, self.use = module, fn, when, use
        self.args = self.result = None

    def __enter__(self):
        self.orig = getattr(self.module, self.fn)
        call = self.use or self.orig

        def wrapped(*a, **k):
            r = call(*a, **k)
            if self.when is None or self.when(a, k):
                self.args, self.result = (a, k), r
            return r

        setattr(self.module, self.fn, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.fn, self.orig)


def run_sensor(sensor, cfg, frames, poses, dev):
    """One path: a new SlamSystem over ``frames`` through the sensor's entry
    point, the launch counts set to 0 just before and read just after.
    Returns (slam, counts, est, gt, seconds per frame)."""
    from orbslam2_tpu_torch import kernels
    from orbslam2_tpu_torch.system import SlamSystem
    from orbslam2_tpu_torch.utils import slices

    slam = SlamSystem(cfg, device=dev)
    kernels.reset_launches()
    est, gt, times = [], [], []
    for i, (frame, Tcw_true) in enumerate(zip(frames, poses)):
        t1 = time.perf_counter()
        pose = slices.track(slam, sensor, frame, i / cfg.camera.fps)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        if pose is not None:
            est.append(np.linalg.inv(pose)[:3, 3])
            gt.append(np.linalg.inv(Tcw_true)[:3, 3])
    return slam, kernels.launch_counts(), est, gt, times


def path_line(name, times, counts):
    fps = len(times) / sum(times)
    print(f"path {name}: {len(times)} frames, {fps:.2f} frames/s, "
          f"{1e3 * sum(times) / len(times):.2f} ms a frame "
          f"({1e3 * sum(times[1:]) / max(len(times) - 1, 1):.2f} after the first), "
          f"launches {counts}")


def stereo_path(dev):
    """The KITTI-width stereo run (slices.config("stereo"), 30 frames):
    tracked >= frames - 1, ATE < 0.045 m, a share of keyframe features with
    u_right >= 0 above 0.3, >= 3 keyframes, V and W on every frame. Returns
    (slam, counts, frames, V's and W's arguments on the last frame)."""
    from orbslam2_tpu_torch.kernels import stereo_match, stereo_sad
    from orbslam2_tpu_torch.utils import slices
    from orbslam2_tpu_torch.utils.evaluation import ate_rmse

    cfg = slices.config("stereo")
    frames, poses = slices.frames("stereo", cfg)
    with Capture(stereo_match, "stereo_match") as cv, \
            Capture(stereo_sad, "stereo_sad") as cw:
        slam, counts, est, gt, times = run_sensor("stereo", cfg, frames, poses, dev)
    m = slam.map
    kfs = m.valid_keyframes()
    share = float((m.kf_ur[kfs][m.kf_feat_valid[kfs]] >= 0).mean())
    ate = ate_rmse(np.array(est), np.array(gt), with_scale=False) if len(est) > 2 else 1e9
    path_line("stereo", times, counts)
    print(f"stereo (KITTI 1241x376, 2000 features, 8 levels, {len(frames)} "
          f"frames): {len(est)} tracked, {len(kfs)} keyframes, "
          f"{len(m.valid_map_points())} points, ATE {ate:.5f} m, stereo share "
          f"{share:.4f}")
    check(len(est) >= len(frames) - 1, f"stereo: {len(est)} of {len(frames)} tracked")
    check(ate < STEREO_ATE, f"stereo ATE {ate} >= {STEREO_ATE}")
    check(share > STEREO_SHARE, f"stereo share {share} <= {STEREO_SHARE}")
    check(len(kfs) >= 3, f"stereo: only {len(kfs)} keyframes")
    for name in ("stereo_match", "stereo_sad"):
        check(counts[name] == len(frames),
              f"{name} launched {counts[name]} times in {len(frames)} frames")
    return slam, counts, frames, cv.args, cw.args


def mono_path(dev):
    """The TUM-width monocular run (slices.config("monocular"), 50 frames):
    >= 25 tracked, ATE with scale < 0.035 m, the final state OK, X launched
    and U launched by SearchForInitialization. Returns (counts, U's and X's
    arguments at the initialisation)."""
    from orbslam2_tpu_torch import tracking
    from orbslam2_tpu_torch.kernels import match_rot, two_view
    from orbslam2_tpu_torch.utils import slices
    from orbslam2_tpu_torch.utils.evaluation import ate_rmse

    cfg = slices.config("monocular")
    frames, poses = slices.frames("monocular", cfg)
    windowed = lambda a, k: k.get("window") is not None  # noqa: E731
    with Capture(match_rot, "match_rot", windowed) as cu, \
            Capture(two_view, "two_view") as cx:
        slam, counts, est, gt, times = run_sensor("monocular", cfg, frames, poses, dev)
    ate = ate_rmse(np.array(est), np.array(gt), with_scale=True) if len(est) > 2 else 1e9
    first = slam.tracker.trajectory[0][0] if slam.tracker.trajectory else -1
    path_line("mono", times, counts)
    print(f"mono (TUM 640x480, 1000 features, 8 levels, {len(frames)} frames): "
          f"{len(est)} tracked (initialised at frame {first}), "
          f"{len(slam.map.valid_keyframes())} keyframes, "
          f"{len(slam.map.valid_map_points())} points, ATE (with scale) {ate:.5f} m")
    check(len(est) >= MONO_TRACKED, f"mono: {len(est)} tracked < {MONO_TRACKED}")
    check(ate < MONO_ATE, f"mono ATE {ate} >= {MONO_ATE}")
    check(slam.tracking_state == tracking.TrackingState.OK, "mono: final state not OK")
    check(counts["two_view"] > 0 and counts["match_rot"] > 0,
          f"mono: X {counts['two_view']}, U {counts['match_rot']} launches")
    return counts, cu.args, cx.args


def fallback_path(dev, slam, pair):
    """One frame of the stereo run (``pair``) through
    Tracker._track_reference_keyframe twice, with kernel U and with its
    plain version: the match sets equal and the poses within 1e-4. Returns
    (counts of the kernel run, U's arguments, ms of the kernel call)."""
    from orbslam2_tpu_torch import kernels
    from orbslam2_tpu_torch.kernels import match_rot

    tr = slam.tracker
    out = {}
    for key, use in (("kernel", None), ("plain", match_rot.match_rot_plain)):
        frame = tr._make_frame(pair[0], 0.0, None, pair[1])
        torch.cuda.synchronize()
        with Capture(match_rot, "match_rot", use=use) as cap:
            kernels.reset_launches()
            t1 = time.perf_counter()
            ok = tr._track_reference_keyframe(frame)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t1)
        out[key] = (ok, frame.Tcw, cap, kernels.launch_counts(), ms)
    (ok_k, T_k, cap_k, counts, ms_k), (ok_p, T_p, cap_p, _, ms_p) = out["kernel"], out["plain"]
    same = all(torch.equal(a, b) for a, b in zip(cap_k.result, cap_p.result))
    check(ok_k and ok_p, f"fallback: tracked {ok_k} (U) / {ok_p} (plain)")
    check(same, "fallback: U's match set differs from the plain matcher's")
    err = float(np.abs(T_k - T_p).max())
    check(err <= 1e-4, f"fallback: poses differ by {err}")
    print(f"fallback (stereo frame, reference keyframe {tr.ref_kf}): "
          f"{int(cap_k.result.valid.sum())} matches, equal sets; pose max diff "
          f"{err:.2e}; {ms_k:.2f} ms with U vs {ms_p:.2f} ms with the plain matcher")
    path_line("fallback", [ms_k / 1e3], counts)
    return counts, cap_k.args, ms_k


def port_rows(dev, record, u_args, uw_args, v_args, w_args, x_args):
    """Kernels U, V, W and X against their plain versions on the arguments
    the paths gave them: U at the fallback's N=2048 (and the monocular
    initialisation's windowed N=1024), V and W on the last stereo frame
    (N=2048, 376x1241), X at the monocular initialisation (N=1024)."""
    from orbslam2_tpu_torch.kernels import (match_rot, stereo_match, stereo_sad,
                                            two_view)
    from orbslam2_tpu_torch.ops import initializer

    # U: idx, dist and valid bit-exact, both call sites
    for args in (u_args, uw_args):
        rk = match_rot.match_rot(*args[0], **args[1])
        rp = match_rot.match_rot_plain(*args[0], **args[1])
        check(all(torch.equal(a, b) for a, b in zip(rk, rp)),
              f"kernel U differs (window {args[1].get('window')})")
    a, kw = u_args
    desc_a, desc_b, valid_a, valid_b = a[:4]
    na, nb = int(valid_a.sum()), int(valid_b.sum())
    n_u = int(match_rot.match_rot(*a, **kw).valid.sum())
    n_uw = int(match_rot.match_rot(*uw_args[0], **uw_args[1]).valid.sum())
    record(match_rot, 0.0, lambda: match_rot.match_rot(*a, **kw),
           cuda_ms(lambda: match_rot.match_rot_plain(*a, **kw)),
           f"fallback Na={desc_a.shape[0]} Nb={desc_b.shape[0]} ({na} x {nb} "
           f"valid): {n_u} matches; SearchForInitialization N="
           f"{uw_args[0][0].shape[0]} (100 px window): {n_uw} matches; both "
           f"bit-exact (timed at the fallback)",
           # descriptors, validity and angles read once, idx, dist, valid
           # written; per valid pair 8 xor + 8 popc + 7 adds, the top-2 and
           # the column atomic (~29 ops); per row the gates and the bin (~20)
           n_bytes=nbytes(*a[:6]) + 9 * desc_a.shape[0],
           n_ops=29 * na * nb + 20 * desc_a.shape[0], per_call=2)

    # V: u_right and depth bit-exact
    va, vkw = v_args
    vk = stereo_match.stereo_match(*va, **vkw)
    vp = stereo_match.stereo_match_plain(*va, **vkw)
    check(all(torch.equal(x, y) for x, y in zip(vk, vp)), "kernel V not bit-exact")
    l_xy, l_oct, _, l_valid, r_xy, r_oct, _, r_valid, sf, bf, min_depth = va
    row_ok = (l_xy[:, None, 1] - r_xy[None, :, 1]).abs() <= 2.0 * sf[l_oct.long()][:, None]
    disp = l_xy[:, None, 0] - r_xy[None, :, 0]
    d_ok = (disp > 0.1) & (disp <= bf / max(min_depth, 1e-6))
    o_ok = ((r_oct[None, :] - l_oct[:, None]).abs() <= 1)
    live = l_valid[:, None] & r_valid[None, :]
    n_pairs = int((row_ok & d_ok & o_ok & live).sum())
    n_live = int(live.sum())
    record(stereo_match, 0.0, lambda: stereo_match.stereo_match(*va, **vkw),
           cuda_ms(lambda: stereo_match.stereo_match_plain(*va, **vkw)),
           f"N={l_xy.shape[0]}: {n_live} live pairs, {n_pairs} in the row, "
           f"disparity and octave band, {int((vk[1] > 0).sum())} matched; "
           f"u_right and depth bit-exact",
           # both frames' features read once, u_right and depth written; per
           # live pair the three gates (~10 ops), per admitted pair the
           # distance and the top-2 (~27)
           n_bytes=nbytes(*(t for t in va if torch.is_tensor(t))) + 8 * l_xy.shape[0],
           n_ops=10 * n_live + 27 * n_pairs)

    # W: u_right and depth bit-exact on the frame's images quantized to 8
    # bits, as a camera delivers them (integer SADs); on the run's float
    # renders the SADs round in another order: >= 99% of the matches within
    # 1e-3 px
    wa, wkw = w_args
    wf = (stereo_sad.stereo_sad(*wa, **wkw), stereo_sad.stereo_sad_plain(*wa, **wkw))
    near = ((wf[0][0] - wf[1][0]).abs() <= 1e-3)[(wf[1][1] > 0) | (wf[0][1] > 0)]
    near = float(near.float().mean()) if near.numel() else 1.0
    check(near >= 0.99, f"kernel W on float images: {near} of matches within 1e-3 px")
    wa = tuple(torch.clamp(torch.round(im), 0, 255) for im in wa[:2]) + tuple(wa[2:])
    wk = stereo_sad.stereo_sad(*wa, **wkw)
    wp = stereo_sad.stereo_sad_plain(*wa, **wkw)
    check(all(torch.equal(x, y) for x, y in zip(wk, wp)), "kernel W not bit-exact")
    left, right, xy_l, ur0, depth0, _ = wa
    Hh, Ww = left.shape
    m = depth0 > 0
    off = torch.arange(-5, 6, device=dev)
    strip = torch.arange(-10, 11, device=dev)
    rows = (torch.round(xy_l[m, 1]).long()[:, None] + off).clamp(0, Hh - 1)
    lc = (torch.round(xy_l[m, 0]).long()[:, None] + off).clamp(0, Ww - 1)
    rc = (torch.round(ur0[m]).long()[:, None] + strip).clamp(0, Ww - 1)
    px_l = int(torch.unique(rows[:, :, None] * Ww + lc[:, None, :]).numel())
    px_r = int(torch.unique(rows[:, :, None] * Ww + rc[:, None, :]).numel())
    n_m = int(m.sum())
    record(stereo_sad, 0.0, lambda: stereo_sad.stereo_sad(*wa, **wkw),
           cuda_ms(lambda: stereo_sad.stereo_sad_plain(*wa, **wkw)),
           f"{Hh}x{Ww}, {n_m} matches refined ({int((wk[1] > 0).sum())} kept); "
           f"u_right and depth bit-exact on 8-bit images, {100 * near:.2f}% "
           f"within 1e-3 px on the run's float renders",
           # the distinct pixels of the left patches and right strips read
           # once, the keypoints' xy, u_right and depth read, u_right and
           # depth written; per match 11 shifts x 121 (sub, abs, add)
           n_bytes=4 * (px_l + px_r) + xy_l.shape[0] * (8 + 4 + 4 + 8),
           n_ops=n_m * 11 * 121 * 3)

    # X: success and used_homography equal, T21 1e-4, good >= 99% of rows,
    # points good in both within 1e-3 relative
    xa, xkw = x_args
    x1, x2, valid, K, samples = xa
    N = x1.shape[0]
    rk = two_view.unpack(two_view.two_view(*xa, **xkw).cpu().numpy(), N)
    rp = two_view.unpack(two_view.two_view_plain(*xa, **xkw).cpu().numpy(), N)
    t_err = float(np.abs(rk.T21 - rp.T21).max())
    g_agree = float((rk.good == rp.good).mean())
    both = rk.good & rp.good
    p_err = float((np.linalg.norm(rk.points3d[both] - rp.points3d[both], axis=1)
                   / np.linalg.norm(rp.points3d[both], axis=1)).max()) if both.any() else 0.0
    check(rk.success == rp.success and rk.used_homography == rp.used_homography,
          f"kernel X: success {rk.success}/{rp.success}, H {rk.used_homography}/"
          f"{rp.used_homography}")
    check(t_err <= 1e-4 and g_agree >= 0.99 and p_err <= 1e-3,
          f"kernel X: T21 {t_err}, good agree {g_agree}, points {p_err}")
    # the work this run's data needs, from the plain stages: the winners'
    # inliers, the candidates of the chosen model (8 for H; F's 4, which X3
    # checks twice), the good points of each
    n_valid = int(valid.sum())
    Kt = torch.as_tensor(K, dtype=torch.float32, device=dev)
    hyp = initializer.hypotheses(x1, x2, valid, samples)
    n_h = int(initializer.score_homography(hyp.H21[torch.argmax(hyp.h_scores)],
                                           x1, x2, valid)[1].sum())
    n_f = int(initializer.score_fundamental(hyp.F21[torch.argmax(hyp.f_scores)],
                                            x1, x2, valid)[1].sum())
    cand = initializer.refine(hyp, x1, x2, valid, Kt)
    chk = initializer.check_hypotheses(cand, x1, x2, valid, Kt)
    n_cand = int(cand.mask.sum())
    n_good = int(chk.n_good.clamp_min(0).sum())
    # the least a 9x9 symmetric eigenvector takes: Householder
    # tridiagonalisation (4 n^3 / 3) and O(n^2) for the eigenvalue and the
    # vector; F's rank 2 by a 3x3 SVD (~150); the denormalisation's two
    # 3x3 products
    eig9 = 4 * 9 ** 3 // 3 + 6 * 9 ** 2
    h_ops = 16 * 45 * 2 + eig9 + 2 * 27 * 2           # 16 DLT rows
    f_ops = 8 * 45 * 2 + eig9 + 150 + 2 * 27 * 2      # 8 rows
    # the library yardstick: torch.linalg.eigh of the 400 hypotheses'
    # 9x9 normal matrices (timed only; the port never calls it)
    x1n, _ = initializer.normalize_points(x1, valid)
    x2n, _ = initializer.normalize_points(x2, valid)
    p1, p2 = x1n[samples.long()], x2n[samples.long()]
    u1, v1, u2, v2 = p1[..., 0], p1[..., 1], p2[..., 0], p2[..., 1]
    z, o = torch.zeros_like(u1), torch.ones_like(u1)
    A_h = torch.cat([torch.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], -1),
                     torch.stack([u1, v1, o, z, z, z, -u2 * u1, -u2 * v1, -u2], -1)], 1)
    A_f = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, o], -1)
    AtA = torch.cat([A_h.transpose(1, 2) @ A_h, A_f.transpose(1, 2) @ A_f])
    lib_x = cuda_ms(lambda: torch.linalg.eigh(AtA))
    record(two_view, t_err, lambda: two_view.two_view(*xa, **xkw),
           cuda_ms(lambda: two_view.two_view_plain(*xa, **xkw), reps=5),
           f"N={N} ({n_valid} matches), success {rk.success}, homography "
           f"{rk.used_homography}; T21 max diff {t_err:.2e}, good agree "
           f"{g_agree:.4f}, points rel {p_err:.2e}; bound over {n_h} H and "
           f"{n_f} F inliers, {n_cand} candidates, {n_good} good points; "
           f"library: torch.linalg.eigh of the 400 normal matrices",
           # the correspondences and samples read once, the packed result
           # written; per H hypothesis its 16-row normal matrix (45 products,
           # mul + add), per F one of 8 rows; per hypothesis and valid
           # correspondence both transfer errors and the score (~40); the
           # refits' rows over the winners' inliers (2 rows an H inlier, 1
           # an F) and their eigen-solves; ~1000 for the decompositions; per
           # candidate and valid correspondence the DLT (the 4x4 system,
           # its normal matrix and eigenvector, ~285) and the cheirality,
           # reprojection and parallax gates (~65); per good point its
           # parallax angle and its share of an O(n) selection of the 50th
           # smallest (~12)
           n_bytes=nbytes(x1, x2, valid, samples) + 4 * (18 + 4 * N),
           n_ops=initializer.N_ITERS * (h_ops + f_ops) + 400 * n_valid * 40
           + (2 * n_h + n_f) * 45 * 2 + 2 * eig9 + 1000
           + n_cand * n_valid * 350 + n_good * 12,
           library_ms=lib_x, per_call=4)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        sys.exit(2)
    # the port first: run outside a checkout, the script fails here before
    # printing anything
    from orbslam2_tpu_torch import kernels
    from orbslam2_tpu_torch.config import ExtractorConfig
    from orbslam2_tpu_torch.kernels import (build, describe, fast_score, hamming,
                                            orb_select, pose_lm)
    from orbslam2_tpu_torch.models.camera import Camera
    from orbslam2_tpu_torch.ops import image as img_ops
    from orbslam2_tpu_torch.ops import orb
    from orbslam2_tpu_torch.kernels.project_gate import project_gate_plain
    from orbslam2_tpu_torch.tracking import TrackingState
    from orbslam2_tpu_torch.utils import slices
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

    def record(mod, err, fn, plain_ms, note, n_bytes, n_ops, library_ms=None,
               per_call=1):
        """One kernel's row: ms is one call of ``fn`` between CUDA events
        (host work included; ``per_call`` launches, e.g. every pyramid
        level), device_ms the kernel's own device time per call, plain_ms
        the plain version's call between CUDA events, library_ms one
        PyTorch call of the same function where there is one."""
        ms = cuda_ms(fn)
        dev_ms = device_ms(fn, mod.FUNCTION, per_call=per_call)
        bound_ms, bound_by = bound(n_bytes, n_ops)
        seen, launched = profile_gaps.pop(mod.FUNCTION, (20 * per_call,) * 2)
        rows.append(dict(name=mod.NAME, route="cuda", source=mod.SOURCE,
                         replaces=mod.REPLACES, max_abs_err=float(err),
                         ms=ms, device_ms=dev_ms,
                         device_events=f"{seen} of {launched}",
                         plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=library_ms))
        lib = "" if library_ms is None else f", library {library_ms:.4f} ms"
        part = ("" if seen == launched else
                f", from a profile that recorded {seen} of {launched} launches")
        print(f"kernel {mod.NAME}: {note}; {ms:.4f} ms a call (device "
              f"{dev_ms:.4f} ms{part}) vs plain {plain_ms:.4f} ms{lib}, bound "
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
    xy_i, _, _, kv = orb_select.orb_select(raw_k, nms_k, budget0, 20.0, 7.0)
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
    print("extraction on the card, all its device work: "
          + ", ".join(extraction_kernels(extractor, frames[0][0])))
    rng = np.random.default_rng(0)
    local_map, d_kp = local_map_case(feats, frames[0][1], rng)
    N, P = feats.xy.shape[0], local_map["pos"].shape[0]
    mp_pos, mp_valid, mp_normal, mp_dmin, mp_dmax = (
        local_map[k] for k in ("pos", "valid", "normal", "dmin", "dmax"))
    cam = Camera.create(FX, FX, W / 2, H / 2, bf=52.0, width=W, height=H)
    T_pred = torch.eye(4, device=dev)
    T_pred[0, 3] = 0.01
    proj, r_px, pred_level, ur_pred, row_valid = project_gate_plain(
        cam, T_pred, mp_pos, mp_valid, mp_normal, mp_dmin, mp_dmax, 15.0, 1.2, 8)
    kp_ur = torch.where(feats.valid, feats.xy[:, 0] - 52.0 / 3.0,
                        torch.full_like(feats.xy[:, 0], -1.0))
    c_args = (local_map["desc"], proj, r_px, pred_level,
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

    cascade_rows(dev, record, cam, local_map, feats, d_kp, T_pred)
    bnd = {r["name"]: r["bound_ms"] for r in rows}
    per_pass = sum(bnd[k] for k in ("project_gate", "hamming_top2_gated",
                                    "claim_resolve", "pose_lm"))
    print(f"cascade bound (a tracked frame): 3 x (O + C + Q + D) + R = "
          f"{3 * per_pass + bnd['cascade_pack']:.6f} ms")
    mapping_rows(dev, record, cam, extractor, frames, poses)
    ba_rows(dev, record)
    front_rows(dev, record, img0, frames[0][1], feats, cam)
    print(f"device times: {len(rows)} kernels; profiles that missed launches "
          f"(kernel, events, launches): {profile_retries or 'none'}")

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

    # ---- phase 4: the RGB-D slice -------------------------------------------
    slam, counts, est, gt, times = run_sensor("rgbd", slices.config("rgbd"), frames,
                                              poses, dev)
    n_kf = len(slam.map.valid_keyframes())
    ate = ate_rmse(np.array(est), np.array(gt), with_scale=False)
    path_line("rgbd", times, counts)
    print(f"rgbd (640x480, 1000 features, 8 levels, {len(frames)} frames): "
          f"{len(est)} tracked, {n_kf} keyframes, "
          f"{len(slam.map.valid_map_points())} points, ATE {ate:.5f} m")
    check(len(est) == len(frames), "rgbd: tracking lost")
    check(slam.tracking_state == TrackingState.OK, "rgbd: final state not OK")
    check(n_kf >= 3, f"rgbd: only {n_kf} keyframes")
    check(ate < ATE_BOUND, f"rgbd ATE {ate} >= {ATE_BOUND}")
    path_counts = {"rgbd": counts}

    # ---- phase 5: the stereo, fallback and monocular paths -----------------
    slam_s, path_counts["stereo"], pairs, v_args, w_args = stereo_path(dev)
    path_counts["fallback"], u_args, _ = fallback_path(dev, slam_s, pairs[-1])
    path_counts["mono"], uw_args, x_args = mono_path(dev)
    for path, names in PATHS.items():
        for name in names:
            check(path_counts[path][name] > 0,
                  f"kernel {name} never launched on the {path} path")
    n_retries = len(profile_retries)
    port_rows(dev, record, u_args, uw_args, v_args, w_args, x_args)
    print(f"device times of U, V, W, X: profiles that missed launches "
          f"(kernel, events, launches): {profile_retries[n_retries:] or 'none'}")
    total = {mod.NAME: sum(c[mod.NAME] for c in path_counts.values())
             for mod in kernels.KERNELS}
    for name, n in total.items():
        check(n > 0, f"kernel {name} launched on no path")
    check(sorted(r["name"] for r in rows) == sorted(total),
          "the kernels line does not hold every kernel once")
    for row in rows:
        row["launches"] = total[row["name"]]

    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
