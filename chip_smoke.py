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
     inputs. Kernel D again with one valid map point NaN and one behind
     the camera: chi2 NaN and 1e9 as its plain version's (the reference's
     jnp.maximum / jnp.minimum keep a NaN), pose and inliers as plain.
     Then: the tracking cascade (kernels O, C, Q, D, R) against the
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
  5. the relocalization path on phase 4's system and map: 3 blank frames
     (LOST), then revisited views until it relocalizes, 3 blank frames again,
     then novel views (mapped poses moved 12 cm and turned 4 degrees, the
     reference test's) until it relocalizes, each within the reference's
     0.15 m, through kernels Y (BoW), U (no rotation check), Z (EPnP RANSAC)
     and O, C, Q, D, R (the projection passes); then save_map, a new
     SlamSystem, load_map in localization mode and 15 frames: >= 10
     tracked, median error < 0.1 m, the map not grown, temporary VO points
     made. Its launch counts are set to 0 just before it and read just
     after; Y, U without the rotation check and Z against their plain
     versions on the arguments the path gave them, and a "reloc" line;
  6. the stereo path: SlamSystem.track_stereo over 30 rendered KITTI-width
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
     against their plain versions on the arguments the paths gave them;
  7. the loop path: the reference's circuit (utils/slices.circuit: 240
     RGB-D frames at 320x240, 600 features, a 1.25-lap orbit in the 10 m
     box room) through SlamSystem with loop closing on by default, at the
     reference test's bounds (a loop closes; keyframe ATE peak > 0.015 m
     before it, after it < 0.7 x the peak and < 0.05 m), launching exactly
     the kernels of PATHS["loop"]; a "loop" line with the closing frame,
     the keyframe pair, the U matches, RANSAC, refined and total matches,
     the ms of each synchronised stage of the closure and the GBA's K, M and
     iterations; K, M's search (bit-exact) and LM, P, F' and C's
     octave-window variant (bit-exact) against their plain versions on the
     arguments the path gave them (M's LM against the plain LM, which
     takes the kernel's accept decision only where its two costs tie
     within their float32 rounding bound, sim3_lm_check);
  8. loop closing at map scale (scale_path): tests/test_capacity_scale.py's
     corridor built by utils/synthetic.corridor_map at the RGB-D path's
     camera and extractor (1300 keyframes, 120 new points a keyframe each
     seen by 8, depths 7-14 m), then LoopCloser.global_bundle_adjustment
     (obs_cap=8) with the reference's sweep geometry (7 windows of 256,
     overlap 64, ~31.5k points a window) to the reference test's bounds
     (RMS centre error after < 0.3 x before, over all keyframes and the
     oldest 1044; finite; the sweep print), and on a copy of the map taken
     before the sweep, its poses drifted 4 mm a link and a loop edge from
     the last keyframe to the first, LoopCloser._optimize_essential_graph
     through kernel P' (n_kf = 1300), the far end's error below 0.2 x its
     start (the reference's PG_GAIN); exactly the kernels of
     PATHS["scale"]; a "scale" line with the milliseconds of each stage
     (map build, each window's gather, solve and write-back, the
     propagation, P' wall and device), P''s CG iterations per LM
     iteration, the windows' sizes and the card. Then P' against its plain
     version on the reference's two 2000-vertex graphs (both to the
     reference's assertions; the circle within 2e-3, and both with one CG
     iteration a solve within 2e-3), against P forced dense on rings of 65,
     384 and 385 keyframes (within 2e-3, both timed in turns), and on the
     loop closer's graph (the same result on a second call; one CG
     iteration a solve within 2e-3; the residuals of both steps at the
     first LM iteration whose CG meets its cap; no (7K)^2 allocation), and
     the sweep's first window against the plain BA schedule, each reading
     within a fixed limit (SWEEP_LIMITS) that a control, the plain
     schedule with its last LM iteration dropped, exceeds in the same run;
  9. the asynchronous system (async_path): (a) phase 4's 36 RGB-D frames
     through AsyncSlamSystem (pipelined tracking at the default depths, the
     mapping and loop-closing workers), then shutdown(), at
     tests/test_pipeline.py's bounds scaled to 36 frames (>= 34 in the
     trajectory, ATE < 0.08 m, >= 3 keyframes), its frames/s beside phase
     4's; (c) the loop circuit three times through AsyncSlamSystem with
     background global BA and the reference's back-pressure wait, each at
     tests/test_loop_e2e.py's async bounds (a loop closes, finite poses,
     keyframe ATE < 0.2 m), an "async" line a run (the closing frame, the
     ATE, each GBA's ms and whether a newer one superseded it, the largest
     keyframe queue, the fuse/BA skips, the longest track_rgbd call while a
     closure or a GBA ran); (b) by profiler, one pipelined frame of a
     Tracker without mapping: only I, A, J, B, L, R', O, C, Q, D, R, the
     feature buffer's fill, memsets and uploads, one device-to-host copy
     into pinned memory and no stream or device synchronize; (d) R'
     against its plain version on the links (a) recorded (1e-6) and the
     chained cascade against the plain chained cascade on (a)'s calls.
     Counts are set to 0 before each run of (a) and (c) and read after its
     shutdown() joined the workers; together they launch exactly
     PATHS["async"]. Kernel M's LM is held on each circuit run's arguments
     as in phase 7: within 1e-4 of the plain LM, which takes the kernel's
     inlier gate between the two phases and its accept decision only
     where its two costs tie within their float32 rounding bound
     (sim3_lm_check);
 10. the offline and dataset surfaces: (b) the vocabulary asset tool's
     corpus (tools/train_default_vocab.py: 296 images at 640x480, 1500
     features, 8 levels; cut to its first 64 images, and said so, where
     the render would take the phase past 180 s) trained to W = 65536
     words in 4 iterations on kernels Y (words only) and Y', then IDF,
     seconds by stage, the words seen in training, the counts set to 0
     just before the training and read just after (exactly PATHS["vocab"]),
     the centres and IDF bit-exact against the plain trainer on the card;
     (c) run_slam tum-rgbd in a subprocess on phase 4's 36 frames written
     as a TUM directory (8-bit PNGs by the standard library's zlib, read
     back through the native decoder, built first): 36 frames, TUM-format
     trajectories, ATE against the written ground truth < 0.10 m (the
     reference dry run's bound; 8-bit images track worse than the float
     renders' 0.035 m), recorded; (d) run_slam kitti-stereo on phase 6's
     30 pairs in the KITTI layout: 30 frames, a KITTI-format trajectory;
     (e) eval_datasets --dry-run: ok, ATE < 0.10 m, >= 20 associated; (f)
     the HTTP viewer on phase 4's system: /state.json's counts equal the
     map's; (a) Y and Y' against their plain versions at W = 65536 and the
     corpus's N on the first iteration's arguments, bit-exact; a "surfaces"
     line. Kernel Y's row at training shape is its own row
     ("bow_words_training", its launches the training's);
 11. the landmark-sharded global BA (mesh_path, slice 10a): (a) meshes of 2
     and 4 shards of the card (parallel/sharded_ba.py) at K=64/M=4096 and
     K=256/M=32768 (O=8, 10 iterations + the outlier round; F and F'
     solving), each solve launching E, G and H once a shard an LM
     iteration, F or F' once and shard_reduce twice (and once a phase),
     held within ba_parity.LIMITS against the plain sharded schedule and
     against the one-shard kernel schedule, a second call the same bits,
     shard_reduce bit-exact against its plain twin on the rows the meshes
     summed; (b) LoopCloser.global_bundle_adjustment(use_mesh=True) over 4
     shards on the circuit's map as phase 7's GBA found it: padded, written
     back, reprojection medians < 1 px; (c) two gloo ranks sharing the card
     through parallel/smoke_worker.py (file:// rendezvous, 120 s a rank at
     most) against (a)'s 2-shard result within LIMITS, both ranks the same
     poses, and a one-rank NCCL group through parallel/distributed.py's
     all-reduce; (d) where the machine shows several cards, a mesh across
     the first min(4, count). Its counts are set to 0 just before (a) and
     read after (c) (exactly PATHS["mesh"]); a "mesh" line with the
     readings and ms per LM iteration for 1, 2 and 4 shards of the one card
     (the overhead of sharding, not scaling), and shard_reduce's row.
Phase 3 also holds the BA schedule at the largest global-BA bucket (K=256,
M=32768, O=8, kernel F' solving), F' beside the library's Cholesky solve
at 6K=1536, P on a drifted 384-keyframe ring against its plain version,
and counts by profiler kernel P''s launches in a 2- and a 4-iteration
call on the 2000-vertex circle (the same launches every LM iteration,
whatever its CG iterations). Then the kernels as one JSON line (times, launches summed over the paths,
the bound from this run's inputs), the card again, and as the last line
{"ok": true, "device": {...}}. Any failure raises and exits non-zero.
Imports nothing of JAX.
"""

import contextlib
import copy
import dataclasses
import io
import json
import os
import statistics
import subprocess
import sys
import time
from collections import defaultdict

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
# the reference's relocalization and localization tests' bounds
RELOC_ERR = 0.15       # m, camera centre after relocalizing
LOC_FRAMES = 15        # localization frames after load_map
LOC_TRACKED = 10       # of them tracked
LOC_MEDIAN = 0.1       # m, median camera-centre error
# the reference loop test's bounds (tests/test_loop_e2e.py)
LOOP_PEAK_ATE = 0.015  # m: the circuit drifted at all
LOOP_GAIN = 0.7        # post ATE < LOOP_GAIN x the peak
LOOP_POST_ATE = 0.05   # m

# the kernels (NAME) each path must launch
FRONT = ("pyramid_level", "fast_score_nms", "orb_select", "orb_describe")
CASCADE = ("project_gate", "hamming_top2_gated", "claim_resolve", "pose_lm",
           "cascade_pack")
MAPPING = ("triangulate", "fuse_match", "point_attrs", "ba_linearize",
           "ba_solve", "ba_update_cost", "ba_accept")
PATHS = {
    "rgbd": FRONT + ("rgbd_depth",) + CASCADE + MAPPING + ("bow_words",),
    "reloc": FRONT + ("rgbd_depth", "bow_words", "match_rot", "pnp_ransac")
    + CASCADE,
    "stereo": FRONT + ("stereo_match", "stereo_sad") + CASCADE + MAPPING
    + ("bow_words",),
    "mono": FRONT + ("match_rot", "two_view") + CASCADE + MAPPING + ("bow_words",),
    "fallback": ("match_rot",) + CASCADE,
    # exactly these: the circuit, its mapping, and one loop closure with GBA
    # at K > 64 (F')
    "loop": FRONT + ("rgbd_depth",) + CASCADE + MAPPING
    + ("bow_words", "match_rot", "sim3_ransac", "sim3_search", "sim3_opt",
       "pose_graph", "ba_solve_blocked"),
    # exactly these: the 1300-keyframe sweep (E, F', G, H) and the
    # essential graph at n_kf = 1300 (P', then N on the moved points)
    "scale": ("ba_linearize", "ba_solve_blocked", "ba_update_cost", "ba_accept",
              "pose_graph_cg", "point_attrs"),
}
# exactly these: the asynchronous RGB-D run and circuit (phase 9), the
# circuit's kernels and the pose chain of pipelined tracking
PATHS["async"] = PATHS["loop"] + ("pose_chain",)
# exactly these: vocabulary training on the asset tool's corpus (phase 10)
PATHS["vocab"] = ("bow_words", "vocab_update")
# the surfaces phase: the runners feed 8-bit PNGs, which track worse than
# the float renders (ROADMAP queue 3), so they are held to the reference
# dry run's bound, their ATE recorded beside the float renders' 0.035 m
SURFACE_ATE = 0.10
DRY_RUN_ASSOC = 20        # tests/test_eval_harness.py's n_assoc bound
VOCAB_PHASE_S = 180.0     # past this the corpus is cut to its first images
VOCAB_CUT = 64            # 64 x ~1500 descriptors >= W = 65536
# H100 SXM peaks (NVIDIA's data sheet, at 700 W): HBM bytes/s and float32
# operations/s outside the tensor cores, where every kernel here runs; Y's
# Hamming product, exact on the int8 tensor cores, is bounded at their rate
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12
PEAK_F64 = 34e12       # float64 outside the tensor cores
PEAK_INT8 = 1979e12    # int8 on the tensor cores, dense


def bound(n_bytes, n_ops):
    """(ms, "bytes" | "operations"): the least time the card could take."""
    t_b, t_o = n_bytes / PEAK_BYTES, n_ops / PEAK_OPS
    return (1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations")


def hamming_bound(n_rows, n_words, n_bytes):
    """bound() of kernel Y's work: the Hamming distances of n_rows
    descriptors to n_words centres are a {0,1} product of depth 256, exact
    on the int8 tensor cores (2 operations a multiply-add), and the argmin
    compares one value a pair on the CUDA cores, concurrently; the slower
    of the two against the bytes."""
    t_o = max(2 * 256 * n_rows * n_words / PEAK_INT8, n_rows * n_words / PEAK_OPS)
    t_b = n_bytes / PEAK_BYTES
    return (1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations")


def hamming_library(desc, vocab, rows=16384):
    """A function of PyTorch calls that gives kernel Y's words: the unpacked
    bits as float16 (every value an integer <= 512, exact), nv - 2 a.v by
    one addmm on the tensor cores, and its argmin (first index on ties), in
    chunks of ``rows`` rows; na + nv - 2 a.v, the reference's distance, has
    the same argmin."""
    from orbslam2_tpu_torch.ops import matching

    a = matching.unpack_bits(desc).half()
    v = matching.unpack_bits(vocab).half()
    nv = v.sum(1)[None]

    def words():
        return torch.cat([torch.addmm(nv, a[s:s + rows], v.T, alpha=-2.0).argmin(1)
                          for s in range(0, a.shape[0], rows)])
    return words


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


def batch_ms(fn, calls, rounds=3):
    """Device ms per call of ``fn`` while the card never waits on the host:
    CUDA events around ``calls`` back-to-back calls, the median of
    ``rounds``. For calls whose device time (milliseconds) covers the next
    call's host work (tens of microseconds)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


profile_retries = []   # (kernel, events seen, launches, lead, trail) of discarded profiles
profile_gaps = {}      # kernel: (events seen, launches) where every profile missed some
profile_fallbacks = {}  # kernel: how its device ms was taken where no profile saw it
# Launches of other kernels on each side of the profiled calls: the profiler
# drops a run of events at a profile's edge later in a long process (the
# rows after phase 11 missed 4 to 23 launches a profile, and all 40 of
# match_rot's once), so the edges are wide and each side is counted.
MARGIN = 64
LEAD_KERNEL, TRAIL_KERNEL = "spin_kernel", "neg_kernel"


def device_events(fn, kernel, reps=20):
    """(device ms, events, (lead, trail)) of the CUDA kernels whose name
    holds ``kernel`` (every device event with ``kernel=None``) over
    ``reps`` calls of ``fn``, from torch.profiler's device events. For a
    named kernel, MARGIN launches of other kernels come before the calls
    (spins of ~50 us) and after them (a negation of one float), each side
    synchronised, so that events the profiler drops at its edges are not
    the kernel's; (lead, trail) counts the margins' events it kept."""
    fn()
    torch.cuda.synchronize()
    pad = torch.zeros(1, device="cuda")

    def margin(launch):
        if kernel is not None:
            for _ in range(MARGIN):
                launch()
            torch.cuda.synchronize()

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        margin(lambda: torch.cuda._sleep(100_000))
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        margin(pad.neg_)
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    events = [e for e in device if kernel is None or kernel in e.key]
    edges = tuple(sum(e.count for e in device if name in e.key)
                  for name in (LEAD_KERNEL, TRAIL_KERNEL))
    return (sum(e.self_device_time_total for e in events) / 1e3,
            sum(e.count for e in events), edges)


def device_ms(fn, kernel, reps=20, per_call=1, attempts=3):
    """Device time in ms per call of ``fn`` of the CUDA kernel named
    ``kernel`` over ``reps`` calls, each launching it ``per_call`` times
    (with ``kernel=None``, of all device events). A profile that saw every
    one of the kernel's launches gives the sum over the calls; one that
    missed any is recorded in ``profile_retries`` and taken again,
    ``attempts`` times at most. If every profile missed launches, the mean
    time of the launches the fullest one recorded, times ``per_call``, and
    the kernel's (events, launches) in ``profile_gaps``. If no profile
    recorded any, CUDA events around ``reps`` back-to-back calls (device
    time with whatever host gaps the calls leave), said in
    ``profile_fallbacks`` and printed."""
    profile_fallbacks.pop(kernel, None)
    best = (0.0, 0)
    for _ in range(attempts):
        total, count, edges = device_events(fn, kernel, reps)
        if kernel is None or count == reps * per_call:
            return total / reps
        profile_retries.append((kernel, count, reps * per_call) + edges)
        best = max(best, (total, count), key=lambda tc: tc[1])
    if best[1] == 0:
        how = (f"CUDA events around {reps} back-to-back calls (no launch in "
               f"{attempts} profiles)")
        profile_fallbacks[kernel] = how
        print(f"device time of {kernel}: {how}")
        return batch_ms(fn, reps)
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


def pose_lm_nan_check(dev, d_args, valid):
    """Kernel D on phase 3's pose problem with one valid map point NaN and
    one behind the camera, against its plain version: the NaN point's chi2
    NaN in both (the reference's jnp.maximum / jnp.minimum keep it), the
    point behind at 1e9, the pose within 1e-4, inlier flags within 0.5% of
    the valid edges, chi2 within 1e-3 relative."""
    from orbslam2_tpu_torch.kernels import pose_lm

    pts = d_args[2].clone()
    nan_i, behind_i = np.where(valid)[0][:2]
    pts[nan_i] = float("nan")
    pts[behind_i, 2] = -3.0
    args = d_args[:2] + (pts,) + d_args[3:]
    Tk, ik, nk, ck = pose_lm.pose_lm(*args)
    Tp, ip, n_p, cp = pose_lm.pose_lm_plain(*args)
    err = (Tk - Tp).abs().max().item()
    flips = int((ik != ip).sum())
    check(bool(torch.isnan(ck[nan_i])) and bool(torch.isnan(cp[nan_i])),
          f"kernel D on a NaN point: chi2 {ck[nan_i].item()}, plain {cp[nan_i].item()}")
    check(ck[behind_i].item() == cp[behind_i].item() == np.float32(1e9),
          f"kernel D on a point behind: chi2 {ck[behind_i].item()}, plain "
          f"{cp[behind_i].item()}")
    check(torch.equal(torch.isnan(ck), torch.isnan(cp))
          and torch.allclose(ck, cp, rtol=1e-3, atol=1e-3, equal_nan=True),
          "kernel D chi2 differs from the plain version's on the NaN case")
    check(err <= 1e-4 and flips <= 0.005 * valid.sum(),
          f"kernel D on the NaN case: pose {err}, inlier flips {flips}")
    print(f"kernel pose_lm: NaN point and point behind: chi2 NaN / 1e9 as "
          f"plain, pose max diff {err:.2e}, inliers {int(nk)} vs {int(n_p)}, "
          f"flags differ at {flips}")


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
                                            ba_solve_blocked, ba_update_cost)
    from orbslam2_tpu_torch.models.camera import Camera
    from orbslam2_tpu_torch.ops import ba
    from orbslam2_tpu_torch.utils import ba_parity
    from orbslam2_tpu_torch.utils.synthetic import ba_window

    cam = Camera.create(FX, FX, W / 2, H / 2, bf=52.0, width=W, height=H)

    def problem(K, M):
        return ba.BAProblem(*(torch.from_numpy(a).to(dev)
                              for a in ba_window(K, M, 8, seed=K)))

    def rel_err(a, b):
        """max |a - b| over max |b| (sums in another order)"""
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
    lin_k2 = ba_linearize.ba_linearize(*e_args)
    check(all(torch.equal(a, b) for a, b in zip(lin_k, lin_k2)),
          "kernel E: a second call differs (its sums are in fixed point)")
    lin_p = ba_linearize.ba_linearize_plain(*e_args)
    errs = [rel_err(a, b) for a, b in zip(lin_k, lin_p)]
    check(max(errs) <= 1e-4, f"kernel E relative errors {errs} > 1e-4")
    record(ba_linearize, (lin_k.S - lin_p.S).abs().max().item(),
           lambda: ba_linearize.ba_linearize(*e_args),
           cuda_ms(lambda: ba_linearize.ba_linearize_plain(*e_args)),
           f"K={K} M={M} O={O}, {n_obs} observations, {n_pairs} pairs; "
           f"relative errors (S, b_S, E, Dinv, b_l) "
           + ", ".join(f"{e:.1e}" for e in errs) + "; a second call the same bits",
           per_call=ba_linearize.LAUNCHES_PER_CALL,
           # inputs read once; S, b_S, E, Dinv, b_l written; per observation
           # projection, Jacobians, weight, its H and b, E, D, b_l, E D^-1
           # and its b_S term (~680 ops), per ordered pair of a landmark's
           # observations a 6x6 block of 3-term dot products and its add
           # (216), per landmark the damped adjugate inverse (~60)
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
           # the Cholesky and its two triangular solves, the
           # symmetrisation, ~200 ops per camera for se3_exp(dc) @ T
           n_bytes=nbytes(*f_args, dc_k, pn_k),
           n_ops=cholesky_ops(n) + n * n + 200 * K)

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
    # a trial step from a failed factorization (NaN) must give a NaN trial
    # cost, as the plain version's, with and without Huber, so that H
    # rejects it
    nan_poses = pn_k.clone()
    nan_poses[-1] = float("nan")
    for huber in (True, False):
        nan_args = (cam, nan_poses, prob.points, *obs, prob.obs_valid,
                    prob.obs_valid, huber)
        c_k = ba_update_cost.ba_update_cost(*nan_args)[1].item()
        c_p = ba_update_cost.ba_update_cost_plain(*nan_args)[1].item()
        check(np.isnan(c_k) and np.isnan(c_p),
              f"kernel G on a NaN trial pose (Huber {huber}): cost {c_k}, plain {c_p}")
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

    # the whole schedule, kernels against the plain schedule: sums in
    # another order, held to ba_parity.LIMITS (poses 1e-4,
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
        f_args = (lin.S, lin.b_S, prob.opt_mask, lam, prob.poses)
        f_name = "F" if K <= ba_solve.MAX_SINGLE_K else "F'"
        f_ms = cuda_ms(lambda: ba_solve.ba_solve(*f_args))
        if K <= ba_solve.MAX_SINGLE_K:
            # F' on F's system: the readings that keep both (PERF.md)
            per = ba_solve_blocked.launches_per_solve(6 * K) + 2
            run_f = lambda: ba_solve.ba_solve(*f_args)  # noqa: E731
            run_b = lambda: ba_solve_blocked.ba_solve_blocked(*f_args)  # noqa: E731
            dev_f = device_ms(run_f, ba_solve.FUNCTION)
            dev_b = device_ms(run_b, ba_solve_blocked.FUNCTION, per_call=per)
            seen, launched = profile_gaps.pop(ba_solve_blocked.FUNCTION, (0, 0))
            part = (f", from a profile that recorded {seen} of {launched} launches"
                    if launched else "")
            print(f"solve K={K} (6K={6 * K}): kernel F {f_ms:.4f} ms (device "
                  f"{dev_f:.4f} ms) vs kernel F' {cuda_ms(run_b):.4f} ms (device "
                  f"{dev_b:.4f} ms, {per} launches{part})")
        print(f"ba K={K} M={M} O=8 iters={iters}+outlier round: kernels "
              f"{ms_k:.3f} ms ({dev_k:.3f} ms on the device) vs plain "
              f"{ms_p:.3f} ms; poses max diff {got['poses']:.2e}, points rel "
              f"{got['points']:.2e} ({got['points_all']:.2e} with the "
              f"{got['loose']} loose ones), reprojection {got['reproj']:.2e} "
              f"px, inlier flips {got['flips']:.1e}, cost "
              f"{rk.cost.item():.3f} vs {rp.cost.item():.3f}; kernel "
              f"{f_name} {f_ms:.4f} ms vs library Cholesky solve {f_lib:.4f} ms "
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


class Stopwatch:
    """Within ``with``, each call of ``obj.name`` is synchronised before
    and after and adds its host-clock seconds to ``acc[key]`` (so the
    split serialises host and device)."""

    def __init__(self, acc, key, obj, name):
        self.acc, self.key, self.obj, self.name = acc, key, obj, name

    def __enter__(self):
        self.own = self.name in vars(self.obj)
        self.orig = getattr(self.obj, self.name)

        def wrapped(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = self.orig(*a, **k)
            torch.cuda.synchronize()
            self.acc[self.key] += time.perf_counter() - t
            return r

        setattr(self.obj, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        if self.own:
            setattr(self.obj, self.name, self.orig)
        else:
            delattr(self.obj, self.name)


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
    (slam, counts, frames, their poses, V's and W's arguments on the last
    frame)."""
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
    return slam, counts, frames, poses, cv.args, cw.args


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


def centre_error(pose, Tcw_true, T0):
    """Camera-centre error of ``pose`` against the truth in the map's frame
    (anchored at the first mapped camera ``T0``)."""
    return float(np.linalg.norm(np.linalg.inv(pose)[:3, 3]
                                - (T0 @ np.linalg.inv(Tcw_true))[:3, 3]))


def reloc_path(dev, slam, frames, poses):
    """Phase 4's system after its 36 frames: 3 blank frames (LOST), then the
    revisited views 10-19 until it relocalizes; 3 blank frames, then novel
    views (poses 8, 12, 16, 20 moved 12 cm right, 3 cm up and turned 4
    degrees, tests/test_tracking_robustness.py's) until it relocalizes;
    each within 0.15 m. Then save_map, a new SlamSystem, load_map in
    localization mode and frames 5-19: >= 10 tracked, median error < 0.1 m,
    no map growth, temporary VO points made. Returns (counts, Y's, U's and
    Z's arguments, the line's fields)."""
    from orbslam2_tpu_torch import kernels
    from orbslam2_tpu_torch.kernels import bow_words, match_rot, pnp_ransac
    from orbslam2_tpu_torch.system import SlamSystem
    from orbslam2_tpu_torch.tracking import TrackingState
    from orbslam2_tpu_torch.utils import slices
    from orbslam2_tpu_torch.utils.synthetic import make_box_room, render

    cfg, tr, kfdb = slam.cfg, slam.tracker, slam.kfdb
    K = slices.intrinsics(cfg)
    planes = make_box_room(seed=0)
    blank = np.zeros((H, W), np.float32)
    yaw = np.deg2rad(4.0)
    Rp = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                   [-np.sin(yaw), 0, np.cos(yaw)]], np.float32)
    novel = []
    for base in poses[8:24:4]:
        Twc = np.linalg.inv(base)
        Twc[:3, :3] = Twc[:3, :3] @ Rp
        Twc[:3, 3] += np.array([0.12, 0.03, 0.0], np.float32)
        T_new = np.linalg.inv(Twc).astype(np.float32)
        novel.append((render(planes, K, T_new, W, H, return_depth=True), T_new))
    revisit = [(frames[i], poses[i]) for i in range(10, 20)]

    acc = defaultdict(float)
    live = lambda a, k: bool(a[1].any())  # noqa: E731  (blank frames have no features)
    no_rot = lambda a, k: not k.get("check_rotation", True)  # noqa: E731
    out = {}
    ts = 100.0
    kernels.reset_launches()
    with Capture(bow_words, "bow_words", live) as cy, \
            Capture(match_rot, "match_rot", no_rot) as cu, \
            Capture(pnp_ransac, "pnp_ransac") as cz, \
            Capture(kfdb, "detect_relocalization_candidates") as cc, \
            Stopwatch(acc, "bow", kfdb, "compute_bow"), \
            Stopwatch(acc, "database", kfdb, "detect_relocalization_candidates"), \
            Stopwatch(acc, "U", match_rot, "match_rot"), \
            Stopwatch(acc, "Z", pnp_ransac, "pnp_ransac"), \
            Stopwatch(acc, "passes", tr, "_project_pass"), \
            Stopwatch(acc, "total", tr, "_relocalize"):
        for name, views in (("revisited", revisit), ("novel", novel)):
            for _ in range(3):
                slices.track(slam, "rgbd", (blank, blank), ts)
                ts += 1.0
            check(slam.tracking_state == TrackingState.LOST, f"reloc: not LOST before {name}")
            acc.clear()
            for attempt, ((img, depth), T_true) in enumerate(views, 1):
                pose = slices.track(slam, "rgbd", (img, depth), ts)
                ts += 1.0
                if pose is not None:
                    break
            check(pose is not None, f"reloc: no relocalization from {len(views)} {name} views")
            err = centre_error(pose, T_true, poses[0])
            pnp_res = pnp_ransac.unpack(cz.result.cpu().numpy(), cz.args[0][1].shape[0])
            out[name] = dict(attempts=attempt, candidates=len(cc.result),
                             winner=int(tr.ref_kf), pnp_inliers=pnp_res.n_inliers,
                             final_inliers=int(tr.n_inliers_last), error_m=err,
                             ms={k: 1e3 * v for k, v in acc.items()})
            check(err < RELOC_ERR, f"reloc ({name}): error {err} m >= {RELOC_ERR}")
        y_args, u_args, z_args = cy.args, cu.args, cz.args

        # localization mode on the saved map
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                            "chip_smoke_map.npz")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        t1 = time.perf_counter()
        slam.save_map(path)
        fresh = SlamSystem(cfg, device=dev)
        fresh.load_map(path, localization_only=True)
        t_io = time.perf_counter() - t1
        os.remove(path)
        n_kf, n_mp = int(fresh.map.kf_valid.sum()), int(fresh.map.mp_valid.sum())
        orig = fresh.tracker._augment_vo_points
        temp = []

        def spy(sel, buf):
            sel2, buf2 = orig(sel, buf)
            temp.append(int((sel2 < 0).sum()))
            return sel2, buf2

        fresh.tracker._augment_vo_points = spy
        errs, times = [], []
        for i in range(5, 5 + LOC_FRAMES):
            t1 = time.perf_counter()
            pose = slices.track(fresh, "rgbd", frames[i], ts)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
            ts += 1.0
            if pose is not None:
                errs.append(centre_error(pose, poses[i], poses[0]))
    counts = kernels.launch_counts()
    med = float(np.median(errs)) if errs else 1e9
    out["localization"] = dict(frames=LOC_FRAMES, tracked=len(errs), median_error_m=med,
                               grew=[int(fresh.map.kf_valid.sum()) - n_kf,
                                     int(fresh.map.mp_valid.sum()) - n_mp],
                               temporary_points_max=max(temp, default=0),
                               save_load_s=t_io, ms_a_frame=1e3 * sum(times) / len(times))
    print("reloc " + json.dumps(out))
    path_line("reloc", times, counts)
    loc = out["localization"]
    check(len(errs) >= LOC_TRACKED, f"localization: {len(errs)} of {LOC_FRAMES} tracked")
    check(med < LOC_MEDIAN, f"localization: median error {med} m >= {LOC_MEDIAN}")
    check(loc["grew"] == [0, 0], f"localization: the map grew by {loc['grew']}")
    check(loc["temporary_points_max"] > 0, "localization: no temporary VO point")
    return counts, y_args, u_args, z_args


def reloc_rows(dev, record, y_args, u_args, z_args):
    """Kernels Y and Z against their plain versions on the arguments the
    relocalization path gave them (Y at its last query with features, Z at
    the winning candidate), and kernel U without the rotation check
    bit-exact (its timing printed beside U's row)."""
    from orbslam2_tpu_torch.kernels import bow_words, match_rot, pnp_ransac
    from orbslam2_tpu_torch.ops import matching, pnp

    # Y: words bit-exact, the vector within 1e-6 relative
    ya, ykw = y_args
    wk, vk = bow_words.bow_words(*ya, **ykw)
    wp, vp = bow_words.bow_words_plain(*ya, **ykw)
    check(torch.equal(wk, wp), "kernel Y: words not bit-exact")
    nz = vp != 0
    check(torch.equal(nz, vk != 0), "kernel Y: the vectors' supports differ")
    rel_y = float(((vk - vp).abs()[nz] / vp.abs()[nz]).max())
    check(rel_y <= 1e-6, f"kernel Y: vector within {rel_y} relative")
    desc, valid, vocab = ya[:3]
    idf = ya[3] if len(ya) > 3 else ykw.get("idf")
    n_valid, Wn = int(valid.sum()), vocab.shape[0]
    y_bytes = nbytes(desc, valid, vocab) + (0 if idf is None else nbytes(idf)) \
        + 4 * desc.shape[0] + 4 * Wn
    library_y = hamming_library(desc[valid], vocab)
    check(torch.equal(library_y().int(), wp[valid]), "the library's words differ")
    record(bow_words, rel_y, lambda: bow_words.bow_words(*ya, **ykw),
           cuda_ms(lambda: bow_words.bow_words_plain(*ya, **ykw)),
           f"N={desc.shape[0]} ({n_valid} valid) x W={Wn}: words bit-exact, vector "
           f"within {rel_y:.2e} relative; bound: the {n_valid} x {Wn} x 256 bit "
           f"product on the int8 tensor cores; library: the float16 product of "
           f"the bits (one addmm) + argmin",
           n_bytes=y_bytes, n_ops=0, library_ms=cuda_ms(library_y), per_call=2,
           bound_override=hamming_bound(n_valid, Wn, y_bytes))

    # U without the rotation check: idx, dist, valid bit-exact
    ua, ukw = u_args
    rk = match_rot.match_rot(*ua, **ukw)
    rp = match_rot.match_rot_plain(*ua, **ukw)
    check(all(torch.equal(a, b) for a, b in zip(rk, rp)),
          "kernel U without the rotation check not bit-exact")
    print(f"kernel match_rot without the rotation check (relocalization, Na="
          f"{ua[0].shape[0]} Nb={ua[1].shape[0]}): {int(rk.valid.sum())} matches, "
          f"bit-exact; {cuda_ms(lambda: match_rot.match_rot(*ua, **ukw)):.4f} ms a call "
          f"vs plain {cuda_ms(lambda: match_rot.match_rot_plain(*ua, **ukw)):.4f} ms")

    # Z: ok equal, inliers >= 99%, rotation 1e-3 rad, translation 1e-3 m
    za, zkw = z_args
    cam, pts, uv, sigma2, zvalid, samples = za
    N, I = pts.shape[0], samples.shape[0]
    rk = pnp_ransac.unpack(pnp_ransac.pnp_ransac(*za, **zkw).cpu().numpy(), N)
    rp = pnp_ransac.unpack(pnp_ransac.pnp_ransac_plain(*za, **zkw).cpu().numpy(), N)
    agree = float((rk.inliers == rp.inliers).mean())
    chord = np.linalg.norm(rk.Tcw[:3, :3].astype(np.float64) - rp.Tcw[:3, :3])
    rot = float(2.0 * np.arcsin(min(chord / (2.0 * np.sqrt(2.0)), 1.0)))
    trans = float(np.abs(rk.Tcw[:3, 3] - rp.Tcw[:3, 3]).max())
    check(rk.ok == rp.ok and agree >= 0.99 and rot < 1e-3 and trans < 1e-3,
          f"kernel Z: ok {rk.ok}/{rp.ok}, inliers agree {agree}, rotation {rot}, "
          f"translation {trans}")
    # the work this run's data needs, from the plain stages: every
    # hypothesis's minimal EPnP, its inlier test over N, the winner's
    # weighted EPnP over its inliers and two more inlier tests
    hyp = pnp.hypotheses(cam, pts, uv, samples)
    _, counts = pnp.count_inliers(hyp, cam, pts, uv, sigma2, zvalid)
    n_best = int(counts.max())
    # the least an EPnP solve takes past its rows: the 3x3 PCA (~150), the
    # 4x4 inverse (~100), a 12x12 eigen-solve for 4 vectors (4 n^3 / 3 +
    # 4 x 6 n^2 ~ 5800), the 6 x 10 system (~400), three least squares
    # (~900), 3 x 5 Gauss-Newton steps (~300 each) and three Horn
    # alignments (~300 each); per point of a set its barycentric
    # coordinates (16), M^T M's two rows (78 x 2 x 2), the depth and SSE of
    # three cases (3 x 40); per point and pose an inlier test (~25, float32)
    solve = 150 + 100 + 5800 + 400 + 900 + 15 * 300 + 3 * 300
    per_point = 16 + 78 * 4 + 120
    f64 = I * (solve + 4 * per_point) + solve + n_best * per_point
    f32 = (I + 2) * N * 25
    z_bytes = nbytes(pts, uv, sigma2, zvalid, samples) + 4 * (18 + N)
    t_ops = f32 / PEAK_OPS + f64 / PEAK_F64
    t_byt = z_bytes / PEAK_BYTES
    s = samples.long()
    ones = torch.ones(s.shape, dtype=torch.float64, device=dev)
    _, _, MtM = pnp.normal_matrices(pts.double()[s], uv.double()[s], ones, cam)
    lib_z = cuda_ms(lambda: torch.linalg.eigh(MtM))
    record(pnp_ransac, max(rot, trans), lambda: pnp_ransac.pnp_ransac(*za, **zkw),
           cuda_ms(lambda: pnp_ransac.pnp_ransac_plain(*za, **zkw), reps=5),
           f"N={N} matches, I={I} hypotheses, best {n_best} inliers; ok {rk.ok}, "
           f"{rk.n_inliers} inliers (plain {rp.n_inliers}), agree {agree:.4f}, "
           f"rotation {rot:.2e} rad, translation {trans:.2e} m; bound: float64 at "
           f"{PEAK_F64 / 1e12:.0f} TFLOP/s, float32 at {PEAK_OPS / 1e12:.0f}; library: "
           f"torch.linalg.eigh of the {I} (12, 12) M^T M",
           n_bytes=z_bytes, n_ops=0, library_ms=lib_z, per_call=2,
           bound_override=(1e3 * max(t_ops, t_byt), "operations" if t_ops >= t_byt else "bytes"))


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


def blocked_rows(dev, record):
    """Kernel F' against its plain version (the same 32-column panels) and
    the library's Cholesky solve on the first LM system of the largest
    global-BA bucket (K=256, M=32768, O=8: 6K = 1536); kernel P on a drifted
    ring at the dense limit, K = 384 (7K = 2688)."""
    from orbslam2_tpu_torch.kernels import (ba_linearize, ba_solve,
                                            ba_solve_blocked, pose_graph)
    from orbslam2_tpu_torch.models.camera import Camera
    from orbslam2_tpu_torch.ops import ba
    from orbslam2_tpu_torch.utils.synthetic import ba_window, pose_graph_ring

    cam = Camera.create(FX, FX, W / 2, H / 2, bf=52.0, width=W, height=H)
    K, M = 256, 32768
    prob = ba.BAProblem(*(torch.from_numpy(a).to(dev)
                          for a in ba_window(K, M, 8, seed=K)))
    lam = torch.full((1,), 1e-4, device=dev)
    lin = ba_linearize.ba_linearize(cam, prob.poses, prob.points, prob.point_valid,
                                    prob.obs_kf, prob.obs_uvr, prob.obs_sigma2,
                                    prob.obs_valid, lam, True)
    f_args = (lin.S, lin.b_S, prob.opt_mask, lam, prob.poses)
    dk, pk = ba_solve_blocked.ba_solve_blocked(*f_args)
    dp, pp = ba_solve_blocked.ba_solve_blocked_plain(*f_args)
    err = (pk - pp).abs().max().item()
    check(err <= 1e-4, f"kernel F' trial poses differ by {err} > 1e-4")
    Sd, b_S, _ = ba_solve.damped_system(lin.S, lin.b_S, prob.opt_mask, lam)
    n = 6 * K
    record(ba_solve_blocked, err, lambda: ba_solve_blocked.ba_solve_blocked(*f_args),
           cuda_ms(lambda: ba_solve_blocked.ba_solve_blocked_plain(*f_args), reps=5),
           f"6K={n} (K={K}, M={M}); trial poses max diff {err:.2e}, steps max "
           f"diff {(dk - dp).abs().max().item():.2e}; "
           f"{ba_solve_blocked.launches_per_solve(n) + 2} launches; library: "
           f"torch.linalg.cholesky + torch.cholesky_solve of the damped system",
           library_ms=cuda_ms(lambda: torch.cholesky_solve(
               b_S[:, None], torch.linalg.cholesky(Sd))),
           # S, b_S, masks and poses read once, steps and poses written;
           # the factorization and its two triangular solves, the damping,
           # ~200 ops per camera for se3_exp(dc) @ T
           n_bytes=nbytes(*f_args, dk, pk),
           n_ops=cholesky_ops(n) + n * n + 200 * K,
           per_call=ba_solve_blocked.launches_per_solve(n) + 2)

    # P at the dense limit, against the plain version
    from orbslam2_tpu_torch.ops.pose_graph import DENSE_MAX_K

    args, _ = pose_graph_ring(DENSE_MAX_K)
    args = [a.to(dev) for a in args]
    rk = pose_graph.optimize_pose_graph(*args, fix_scale=True)
    rp = pose_graph.optimize_pose_graph_plain(*args, fix_scale=True)
    err_c, err_r = pose_diff(rk.poses, rp.poses, args[2])
    check(err_c <= 1e-3 and err_r <= 1e-3,
          f"kernel P at K=384: centres {err_c} m, rotations {err_r} rad")
    n = 7 * args[0].shape[0]
    g = torch.Generator(device=dev).manual_seed(1)
    B = torch.randn(n, n, device=dev, generator=g)
    A = B @ B.T / n + torch.eye(n, device=dev)
    rhs = torch.randn(n, 1, device=dev, generator=g)
    ms_k = cuda_ms(lambda: pose_graph.optimize_pose_graph(*args, fix_scale=True),
                   reps=3, warmup=1)
    ms_p = cuda_ms(lambda: pose_graph.optimize_pose_graph_plain(
        *args, fix_scale=True), reps=3, warmup=1)
    ms_l = cuda_ms(lambda: torch.cholesky_solve(rhs, torch.linalg.cholesky(A)))
    print(f"kernel pose_graph at the dense limit (K={DENSE_MAX_K}, E="
          f"{args[3].shape[0]}, 20 iterations): centres max diff {err_c:.2e} m, "
          f"rotations {err_r:.2e} rad; {ms_k:.3f} ms a call vs plain "
          f"{ms_p:.3f} ms; library Cholesky solve of one n={n} system "
          f"{ms_l:.4f} ms")





def loop_path(dev):
    """The reference's loop circuit (utils/slices.circuit: 240 RGB-D frames,
    320x240, 600 features, a 1.25-lap orbit in the 10 m box room) through
    SlamSystem(cfg, device=cuda), loop closing on by default, to the
    reference's four bounds. Launch counts are set to 0 just before and
    read just after; each stage of the closing keyframe's loop closure is
    synchronised and timed. Returns (counts, the captured arguments of the
    loop's kernels, the "loop" line's fields)."""
    from orbslam2_tpu_torch import kernels
    from orbslam2_tpu_torch.kernels import (ba_solve_blocked, hamming,
                                            pose_graph, sim3_opt, sim3_ransac,
                                            sim3_search)
    from orbslam2_tpu_torch.system import SlamSystem
    from orbslam2_tpu_torch.utils import slices
    from orbslam2_tpu_torch.utils.profile_slice import LOOP_STAGES

    frames, poses = slices.circuit()
    slam = SlamSystem(slices.config("circuit"), device=dev)
    closer = slam.loop_closer
    owners = dict(closer=closer, sim3_ransac=sim3_ransac,
                  sim3_search=sim3_search, sim3_opt=sim3_opt)
    acc = defaultdict(float)
    closure = {}
    process = closer.process_keyframe

    snap_s = []   # seconds of the snapshot below, left out of the stages

    def timed_process(kf, *a, **k):
        acc.clear()
        snap_s.clear()
        torch.cuda.synchronize()
        t = time.perf_counter()
        closed = process(kf, *a, **k)
        torch.cuda.synchronize()
        if closed and not closure:
            if snap_s:
                acc["gba_gather"] -= sum(snap_s)
            closure.update(ms={key: 1e3 * v for key, v in acc.items()},
                           stats=dict(closer.last_stats))
            closure["ms"]["total"] = 1e3 * (time.perf_counter() - t - sum(snap_s))
        return closed

    closer.process_keyframe = timed_process
    variant_calls = []

    def no_window(a, k):
        """C's loop variant (no octave window); counts its launches"""
        hit = k.get("octave_window", (-1, 0)) is None
        variant_calls.extend([1] if hit else [])
        return hit

    # the map as its global BA finds it (phase 11 runs the mesh GBA on it)
    before_gba = {}
    gather = closer._gba_gather

    def snapshot_gather(*a, **k):
        if not before_gba:
            t = time.perf_counter()
            before_gba.update(map_snapshot(closer.map))
            snap_s.append(time.perf_counter() - t)
        return gather(*a, **k)

    closer._gba_gather = snapshot_gather
    peak, first_close, times = 0.0, None, []
    kernels.reset_launches()
    with contextlib.ExitStack() as stack:
        caps = {name: stack.enter_context(Capture(mod, fn, when)) for name, mod, fn, when in (
            ("K", sim3_ransac, "sim3_ransac", None),
            ("M_search", sim3_search, "search_by_sim3", None),
            ("M_opt", sim3_opt, "optimize_sim3", None),
            ("C", hamming, "hamming_top2_gated", no_window),
            ("P", pose_graph, "optimize_pose_graph", None),
            ("F'", ba_solve_blocked, "ba_solve_blocked", None),
            ("gba", closer, "_gba_solve", None))}
        for owner, name, key in LOOP_STAGES:
            stack.enter_context(Stopwatch(acc, key, owners[owner], name))
        for i, (img, depth) in enumerate(frames):
            t1 = time.perf_counter()
            slam.track_rgbd(img, depth, i / 30.0)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
            if closer.loops_closed == 0:
                a = slices.keyframe_ate(slam, poses)
                if a is not None:
                    peak = max(peak, a)
            elif first_close is None:
                first_close = i
    counts = kernels.launch_counts()
    del closer._gba_gather
    post = slices.keyframe_ate(slam, poses)
    n_kf = len(slam.map.valid_keyframes())
    path_line("loop", times, counts)
    print(f"loop circuit (320x240, 600 features, {len(frames)} frames): "
          f"{closer.loops_closed} loops closed, {n_kf} keyframes, keyframe ATE "
          f"peak {peak:.5f} m before the loop, {post:.5f} m after")
    check(closer.loops_closed >= 1, "loop: no loop closed over the circuit")
    check(peak > LOOP_PEAK_ATE, f"loop: circuit accumulated no drift ({peak})")
    check(post < LOOP_GAIN * peak, f"loop: ATE {post} not < {LOOP_GAIN} x {peak}")
    check(post < LOOP_POST_ATE, f"loop: ATE {post} >= {LOOP_POST_ATE}")
    gba_prob, gba_iters = caps["gba"].args[0][0], caps["gba"].args[0][1]
    fields = dict(frame=first_close, **closure["stats"], ms=closure["ms"],
                  c_variant_launches=len(variant_calls),
                  gba=dict(K=int(gba_prob.poses.shape[0]),
                           M=int(gba_prob.points.shape[0]), iters=int(gba_iters)),
                  peak_ate=peak, post_ate=post, keyframes=n_kf)
    args = {k: c.args for k, c in caps.items()}
    args["map_before_gba"] = before_gba
    return counts, args, fields


def map_snapshot(m):
    """Copies of a MapState's fields, for ``map_state_from_numpy``."""
    return {f.name: copy.deepcopy(getattr(m, f.name))
            for f in dataclasses.fields(m)
            if f.name not in ("cfg", "lock", "dev_kf", "device")}


# Float operations of csrc/sim3.cuh's routines, counted from its source
# (an add, multiply, divide, compare, root or transcendental is one; the
# branch a value takes in the general case): quat_to_rotmat 52, matmul3 45,
# rotmat_to_quat 38, so3_exp 97, sim3_W 125, so3_log 27, solve3 40.
SIM3_COMPOSE = 2 * 52 + 45 + 21 + 1 + 38
SIM3_INVERSE = 52 + 2 + 19 + 38
SIM3_EXP = 125 + 97 + 15 + 38
SIM3_LOG = 2 + 52 + 27 + 125 + 40
# csrc/pose_graph.cu's edge residual log(S_ij exp(d_j) exp(x_j) M_ij
# exp(-x_i) exp(-d_i)): 5 compositions, 4 exponentials, 21 sign changes
# and scalings, the logarithm (2412 operations)
EDGE_RES = 5 * SIM3_COMPOSE + 4 * SIM3_EXP + 21 + SIM3_LOG
# a Dual<7> operation against its float one: an add 8 operations, a
# multiply 22, a divide 23, a function ~10; weighed over the residual's mix
# (about half multiplies, two fifths adds), 15
DUAL7 = 15


def cholesky_ops(n):
    """Operations of a Cholesky factorization of n unknowns (n^3/6
    multiply-adds) and its two triangular solves (n^2/2 each)."""
    return n ** 3 // 3 + 2 * n * n


def loop_rows(dev, record, args):
    """Kernels K, M (search and LM), P, F' and C's octave-window variant
    against their plain versions on the arguments the loop path gave them,
    and the rows of K, both of M's and P."""
    from orbslam2_tpu_torch.kernels import (ba_solve_blocked, hamming,
                                            pose_graph, sim3_opt, sim3_ransac,
                                            sim3_search)
    from orbslam2_tpu_torch.ops import geometry as geo
    from orbslam2_tpu_torch.ops import sim3_opt as sim3_ops

    # K: inlier sets >= 99% equal, S12 within 1e-4, counts within 1%
    a, kw = args["K"]
    cam = a[0]
    n, n_samples, n_match = a[1].shape[0], a[6].shape[0], int(a[5].sum())
    rk = sim3_ransac.unpack(sim3_ransac.sim3_ransac(*a, **kw).cpu().numpy(), n)
    rp = sim3_ransac.unpack(sim3_ransac.sim3_ransac_plain(*a, **kw).cpu().numpy(), n)
    err_k = float(np.abs(rk.S12 - rp.S12).max())
    agree = float((rk.inliers == rp.inliers).mean())
    check(err_k <= 1e-4 and agree >= 0.99 and abs(rk.n_inliers - rp.n_inliers)
          <= max(1, n // 100), f"kernel K: S12 {err_k}, inliers agree {agree}, "
          f"{rk.n_inliers} vs {rp.n_inliers}")

    def horn_eigh():
        """the library's eigh of the hypotheses' 4x4 Horn matrices"""
        idx = a[6].long()
        src, dst = a[2][idx], a[1][idx]
        sc, dc = src - src.mean(1, keepdim=True), dst - dst.mean(1, keepdim=True)
        return torch.linalg.eigh(geo.horn_matrix(
            torch.einsum("hni,hnj->hij", sc, dc) / 3.0))

    record(sim3_ransac, err_k, lambda: sim3_ransac.sim3_ransac(*a, **kw),
           cuda_ms(lambda: sim3_ransac.sim3_ransac_plain(*a, **kw)),
           f"N={n} ({n_match} matched), {n_samples} hypotheses, "
           f"fix_scale={kw.get('fix_scale')}: {rk.n_inliers} vs {rp.n_inliers} "
           f"inliers, inlier sets agree {agree:.4f}, S12 max diff {err_k:.2e}; "
           f"library: torch.linalg.eigh of {n_samples} 4x4 matrices",
           library_ms=cuda_ms(horn_eigh),
           # points, sigmas, validity and samples read once, the packed
           # result written; per hypothesis and matched point (the kernel
           # skips the rest) two Sim3 applications, two projections and
           # chi2 (~70 ops), the refit's sums and recounts (~300 per point)
           n_bytes=nbytes(*a[1:7]) + 4 * (10 + n),
           n_ops=70 * n_samples * n_match + 300 * n_match, per_call=2)

    # M's search: idx2 and mutual bit-exact
    a, kw = args["M_search"]
    ik, mk = sim3_search.search_by_sim3(*a, **kw)
    ip, mp = sim3_search.search_by_sim3_plain(*a, **kw)
    check(torch.equal(ik, ip) and torch.equal(mk, mp), "kernel M's search differs")
    cam, S12 = a[0], a[1]
    pairs = gates = 0
    parts21, parts12 = sim3_ops.search_parts(S12)
    for parts, src, dst in ((parts21, a[2:8], a[8:14]), (parts12, a[8:14], a[2:8])):
        rows, pair = sim3_ops.direction_pairs(cam, parts, src[0], src[3], dst[4],
                                              dst[5], a[14], a[15])
        rows = rows & src[2]
        gates += int(rows.sum()) * int(dst[2].sum())
        pairs += int((pair & rows[:, None] & dst[2][None]).sum())
    n1, n2 = a[2].shape[0], a[8].shape[0]
    record(sim3_search, 0.0, lambda: sim3_search.search_by_sim3(*a, **kw),
           cuda_ms(lambda: sim3_search.search_by_sim3_plain(*a, **kw)),
           f"bit-exact; N1={n1} N2={n2}, {int(mk.sum())} mutual matches, "
           f"{pairs} admitted pairs",
           # both sides read once, idx2 and mutual written; per source row
           # the transform, projection and level (~60 ops), per (row,
           # keypoint) of a live row the gate (~10), per admitted pair the
           # 256-bit distance and the minimum (~27)
           n_bytes=nbytes(*a[2:14]) + 5 * n1, per_call=2,
           n_ops=60 * (n1 + n2) + 10 * gates + 27 * pairs)

    # M's LM: S12 within 1e-4 of the plain LM, which follows the kernel's
    # decisions only at ties within the cost sums' rounding, counts within 1
    a, kw = args["M_opt"]
    n = a[2].shape[0]
    rk, rp, err_m, gate = sim3_lm_check("loop", a, kw)
    n_valid = int(a[8].sum())
    record(sim3_opt, err_m, lambda: sim3_opt.optimize_sim3(*a, **kw),
           cuda_ms(lambda: sim3_opt.optimize_sim3_plain(*a, **kw), reps=3),
           f"N={n}, {n_valid} pairs, {rk.n_inliers} vs {rp.n_inliers} inliers, "
           f"S12 max diff {err_m:.2e} ({gate})",
           # the pairs read once, the packed result written; 15 iterations
           # over the valid pairs of the 4 residual rows in dual numbers
           # (~1300 ops), H and g (~280), both trial costs (~120)
           n_bytes=nbytes(*a[1:9]) + 4 * (9 + n), n_ops=15 * 1700 * n_valid)

    # C's variant (no octave window, 10 px): bit-exact
    a, kw = args["C"]
    out_k = hamming.hamming_top2_gated(*a, **kw)
    out_p = hamming.hamming_top2_gated_plain(*a, **kw)
    check(all(torch.equal(x, y) for x, y in zip(out_k, out_p)),
          "kernel C's octave-window variant differs")
    fn_c = lambda: hamming.hamming_top2_gated(*a, **kw)  # noqa: E731
    ms_c = cuda_ms(fn_c)
    dev_c = device_ms(fn_c, hamming.FUNCTION)
    rows_c = int(a[5].sum())
    in_r = ((a[1][a[5]][:, None, :] - a[7][None]) ** 2).sum(-1) <= 100.0
    in_r = in_r & a[9][None]
    # as C's row: the gate (~10 ops) for every valid row and keypoint, the
    # distance and top-2 update (~27) for the pairs inside the radius
    bound_c, by_c = bound(sum(t.numel() * t.element_size() for t in a) + 16 * a[0].shape[0],
                          10 * rows_c * int(a[9].sum()) + 27 * int(in_r.sum()))
    print(f"kernel hamming_top2_gated (loop acceptance count, no octave window, "
          f"10 px): bit-exact; P={a[0].shape[0]} ({rows_c} in view) x "
          f"N={a[6].shape[0]}, {int(((out_k[1] <= 50) & a[5]).sum())} matches; "
          f"{ms_c:.4f} ms a call (device {dev_c:.4f} ms) vs plain "
          f"{cuda_ms(lambda: hamming.hamming_top2_gated_plain(*a, **kw)):.4f} ms, "
          f"bound {bound_c:.6f} ms ({by_c}), library none")

    # F' on the GBA's last system: trial poses within 1e-4
    a, kw = args["F'"]
    dk, pk = ba_solve_blocked.ba_solve_blocked(*a, **kw)
    dp, pp = ba_solve_blocked.ba_solve_blocked_plain(*a, **kw)
    err_f = (pk - pp).abs().max().item()
    check(err_f <= 1e-4, f"kernel F' on the GBA system: poses differ by {err_f}")
    print(f"kernel ba_solve_blocked (the loop's GBA, 6K={6 * a[4].shape[0]}): "
          f"trial poses max diff {err_f:.2e}; "
          f"{cuda_ms(lambda: ba_solve_blocked.ba_solve_blocked(*a, **kw)):.4f} ms "
          f"a call vs plain "
          f"{cuda_ms(lambda: ba_solve_blocked.ba_solve_blocked_plain(*a, **kw)):.4f} ms")

    # P: camera centres within 1e-3 m, rotations within 1e-3 rad
    a, kw = args["P"]
    pk = pose_graph.optimize_pose_graph(*a, **kw)
    pp = pose_graph.optimize_pose_graph_plain(*a, **kw)
    err_c, err_r = pose_diff(pk.poses, pp.poses, a[2])
    check(err_c <= 1e-3 and err_r <= 1e-3,
          f"kernel P: centres {err_c} m, rotations {err_r} rad")
    K, E, E_valid = a[0].shape[0], a[3].shape[0], int(a[6].sum())
    n = 7 * K
    iters = kw.get("iters", 20)
    g = torch.Generator(device=dev).manual_seed(0)
    B = torch.randn(n, n, device=dev, generator=g)
    A_spd = B @ B.T / n + torch.eye(n, device=dev)
    rhs = torch.randn(n, 1, device=dev, generator=g)
    record(pose_graph, max(err_c, err_r), lambda: pose_graph.optimize_pose_graph(*a, **kw),
           cuda_ms(lambda: pose_graph.optimize_pose_graph_plain(*a, **kw), reps=3,
                   warmup=1),
           f"K={K} slots ({int(a[2].sum())} live), E={E}, {iters} iterations: "
           f"centres max diff {err_c:.2e} m, rotations {err_r:.2e} rad, cost "
           f"{pk.cost.item():.3e} vs {pp.cost.item():.3e}; library: "
           f"torch.linalg.cholesky + torch.cholesky_solve of one n={n} system "
           f"(one iteration's solve)",
           library_ms=cuda_ms(lambda: torch.cholesky_solve(
               rhs, torch.linalg.cholesky(A_spd))),
           function=None,
           # the graph read once, the poses written; the start: four costs
           # over the valid edges, each edge's base-relative transform, per
           # vertex its centre, chain link, re-integration and ramp (7
           # compositions, 2 inverses, 2 exponentials, 2 logarithms); per
           # iteration and valid edge the residual in two Dual<7> passes,
           # the gradient's and three 7x7 blocks' products (2254) and the
           # trial cost's residual; the system's lower triangle, the
           # factorization and solves, per vertex the step (2 exponentials,
           # a composition, a logarithm); at the end 2 compositions and an
           # exponential a vertex
           n_bytes=nbytes(*a) + 4 * (8 * K + 1),
           n_ops=(4 * E_valid * EDGE_RES + E * (SIM3_COMPOSE + SIM3_INVERSE)
                  + K * (7 * SIM3_COMPOSE + 2 * SIM3_INVERSE + 2 * SIM3_EXP
                         + 2 * SIM3_LOG + 120)
                  + iters * (E_valid * (EDGE_RES * (2 * DUAL7 + 1) + 2254)
                             + n * n // 2 + cholesky_ops(n)
                             + K * (2 * SIM3_EXP + SIM3_COMPOSE + SIM3_LOG))
                  + K * (2 * SIM3_COMPOSE + SIM3_EXP)))


U32 = 2.0 ** -24  # float32's unit roundoff


def edge_rounding(a):
    """Per pair of the LM's arguments ``a``, a bound on the float32
    rounding of the norm of each edge's scaled residual (forward, inverse)
    at the LM's start S12_0: the point through the Sim3, X = s R p + t, to
    8u (s |p|_1 + |t|_inf) a component (the rotation from the quaternion,
    the products and sums, the inverse's own terms); the projection
    f X/Z + c, the difference with the keypoint and the scaling by
    1/sigma each to a few u of their operands; the norm to 4u."""
    from orbslam2_tpu_torch.ops import geometry as geo

    cam, S0, p1c, p2c, u1, u2, s2_1, s2_2 = a[:8]
    f, c = max(cam.fx, cam.fy), max(abs(cam.cx), abs(cam.cy))
    out = []
    for S, p, uv, s2 in ((S0, p2c, u1, s2_1), (geo.sim3_inverse(S0), p1c, u2, s2_2)):
        s, t = geo.sim3_s(S), geo.sim3_t(S)
        X = geo.sim3_apply(S[None], p)
        z = X[:, 2].abs().clamp_min(1e-8)
        q = X[:, :2].abs().amax(1) / z
        dX = 8 * U32 * (s * p.abs().sum(1) + t.abs().max())
        d_pred = f * (dX * (1 + q) / z + 2 * U32 * q) + U32 * (f * q + c)
        mag = uv.abs().amax(1) + f * q + c      # |u_obs| + |pred|, >= |r| sigma
        inv_s = 1.0 / torch.sqrt(s2.clamp_min(1e-9))
        d_comp = inv_s * (d_pred + 5 * U32 * mag)
        out.append(2 ** 0.5 * d_comp + 4 * U32 * inv_s * mag)
    return out


def sum_rounding(cost, n_terms, d_edges):
    """A bound on the float32 rounding of a robust cost sum ``cost`` of
    ``n_terms`` Huber terms whose residual norms are each rounded by at
    most d_edges (a vector): the summation in any order, (n - 1) u cost,
    Huber's own operations, 3u cost, and the residuals' rounding through
    the Huber slope 2 min(e, delta): by Cauchy-Schwarz at most
    2 sqrt(cost) |d|_2 + |d|_2^2."""
    d2 = float((d_edges ** 2).sum())
    return (n_terms + 2) * U32 * cost + 2 * (cost * d2) ** 0.5 + d2


def sim3_lm_check(label, a, kw):
    """Kernel M's LM against the plain LM on its arguments ``a``, ``kw``.
    Each LM iteration takes its step where the robust cost at the trial
    S12 lies below the cost at the current one. The kernel reports both
    costs of each iteration; the plain LM takes its own decision except
    where its two costs lie within the tie bound of each other, twice the
    sum of both sums' float32 rounding bounds (sum_rounding over
    edge_rounding): there a sum taken in the other order may decide the
    other way, and the plain LM takes the kernel's decision. The check
    fails on any decision of the kernel's against the plain LM's outside
    the tie bound, on S12 more than 1e-4 from the plain LM's, and on
    inlier counts more than 1 apart. Between the phases the plain LM takes
    the kernel's chi2 gate, its first-phase inlier set (the pairs that
    flipped at the gate are counted). The costs at each iteration whose
    decisions differ are printed with the bound. Returns (kernel result,
    plain result, their S12 difference, the note)."""
    from orbslam2_tpu_torch.kernels import sim3_opt
    from orbslam2_tpu_torch.ops import sim3_opt as sim3_ops

    n, dev = a[2].shape[0], a[2].device
    unpack = lambda t: sim3_opt.unpack(t.cpu().numpy(), n)  # noqa: E731
    costs = torch.zeros(sim3_ops.ITERS1 + sim3_ops.ITERS2, 2, device=dev)
    rk = unpack(sim3_opt.optimize_sim3(*a, costs=costs, **kw))
    ck = costs.tolist()
    mid_k = unpack(sim3_opt.optimize_sim3(*a, iters2=0, **kw))
    mid_p = unpack(sim3_opt.optimize_sim3_plain(*a, iters2=0, **kw))
    flips = int((mid_k.inliers != mid_p.inliers).sum())
    mid_inl = torch.from_numpy(mid_k.inliers).to(dev)
    d_fwd, d_inv = edge_rounding(a)
    valid = a[8]
    rows = []

    def decide(it, c_new, c_cur):
        mask = valid if it < sim3_ops.ITERS1 else mid_inl & valid
        d = torch.cat([d_fwd[mask], d_inv[mask]])
        pn, pc = float(c_new), float(c_cur)
        tie = 2 * (sum_rounding(pn, d.numel(), d) + sum_rounding(pc, d.numel(), d))
        kn, kc = ck[it]
        own, kern = pn < pc, kn < kc
        rows.append((it, kn, kc, pn, pc, tie, own != kern))
        return kern if abs(pn - pc) <= tie else own

    rp = unpack(sim3_opt.optimize_sim3_plain(*a, mid_inliers=mid_inl,
                                             decide=decide, **kw))
    differ = [r for r in rows if r[6]]
    outside = [r for r in differ if abs(r[3] - r[4]) > r[5]]
    err_m = float(np.abs(rk.S12 - rp.S12).max())
    note = (f"first-phase inliers {mid_k.n_inliers} vs {mid_p.n_inliers}, {flips} "
            f"flipped at the gate; accept decisions (kernel "
            f"{''.join(str(int(r[1] < r[2])) for r in rows)}) differ at "
            + (", ".join(f"iteration {it}: kernel costs {kn:.6f} / {kc:.6f}, "
                         f"plain {pn:.6f} / {pc:.6f}, gap {pn - pc:.2e}, tie bound "
                         f"{tie:.2e}" for it, kn, kc, pn, pc, tie, _ in differ)
               or "none")
            + f"; smallest tie bound {min(r[5] for r in rows):.2e}")
    print(f"kernel sim3_opt ({label}): S12 vs the plain LM {err_m:.2e}, inliers "
          f"{rk.n_inliers} vs {rp.n_inliers}; {note}")
    check(not outside, f"kernel M's LM ({label}): accept decisions differ outside "
          f"the tie bound at iterations {[r[0] for r in outside]}")
    check(err_m <= 1e-4 and abs(rk.n_inliers - rp.n_inliers) <= 1,
          f"kernel M's LM ({label}): S12 {err_m}, inliers {rk.n_inliers} vs "
          f"{rp.n_inliers}")
    return rk, rp, err_m, note


def pose_diff(Sa, Sb, valid):
    """(camera centres' max difference, rotations' max angle) over the
    valid vertices of two (K, 8) Sim3 sets."""
    from orbslam2_tpu_torch.ops import geometry as geo

    dc = (centre(Sa) - centre(Sb)).norm(dim=1)[valid]
    dR = geo.sim3_R(Sa).transpose(-1, -2) @ geo.sim3_R(Sb)
    return dc.max().item(), geo.so3_log(dR).norm(dim=1)[valid].max().item()


# the scale phase's map (tests/test_capacity_scale.py::TestGbaSweep's
# corridor at the RGB-D main path's camera and extractor): 1300 keyframes,
# 120 new points a keyframe each seen by 8 (so ~31.5k points in a window of
# 256 and O = 8), depths 7-14 m so that the last of the 8 observers (5.6 m
# further along) still sees each point in front
SCALE_KFS = 1300
SCALE_P_NEW = 120
SCALE_SPAN = 8
SCALE_DEPTH = (7.0, 14.0)
SCALE_GAIN = 0.3       # the reference sweep test's: error after < 0.3 x before
SCALE_OLDEST = 1044    # the keyframes a newest-256 truncation never touches
PG_GAIN = 0.2          # the reference graph tests': far end < 0.2 x its start
PG_TOL = 2e-3          # the reference's test_cg_matches_dense tolerance
# CG iterations a solve of the P' parity runs on the capped graphs: their
# float32 systems are indefinite in the chain's softest modes (the rounding
# of the blocks is larger than those eigenvalues and lam), so from its
# second iteration CG steps on them are decided by rounding (PERF.md
# section 7); one iteration a solve is determined by the inputs (the plain
# version's pose vectors move by 2.4e-4 to 3.7e-4 on the loop closer's
# graph under a 1e-7 change of the start: utils/cg_study.py)
PG_PARITY_CG = 1
# the sweep's first window (K = 256, M = 30720, O = 8, exact measurements,
# cameras up to 205 m from the origin, where a float32 ulp of a position is
# 1.5e-5 m) against the plain schedule. Readings of sound runs on the H100
# (PERF.md section 7), kernels against plain and against their own second
# run: poses <= 7.6e-5, points <= 3.3e-6, reproj <= 2.25e-2 px, cost <=
# 2.31e-2 relative, no flips; the control, the plain schedule with its last
# of 10 LM iterations dropped: poses 1.19e-3, points 3.27e-5, reproj 0.157
# px, cost 0.0985. Each limit lies between the two: 2.2x to 3x above the
# sound readings, 2x to 6x below the control;
# flips has no control (exact data has no outliers) and keeps ba_parity's
SWEEP_LIMITS = dict(poses=2e-4, points=1e-5, reproj=5e-2, flips=1e-3, cost=5e-2)
SWEEP_CONTROLLED = ("poses", "points", "reproj", "cost")
# drift of each odometry link of the essential-graph case (m along the
# camera's z, the corridor's forward axis)
SCALE_DRIFT = 0.004


def centre(S):
    """Camera centres of (..., 8) Sim3 vectors."""
    from orbslam2_tpu_torch.ops import geometry as geo

    R, t, s = geo.sim3_R(S), geo.sim3_t(S), geo.sim3_s(S)
    return -(R.transpose(-1, -2) @ t[..., None])[..., 0] / s[..., None]


def rms_centre_error(m, kf_ids):
    """RMS camera-centre error of ``kf_ids`` (the corridor's keyframes i =
    0, 1, ... in creation order) against the corridor's true poses."""
    from orbslam2_tpu_torch.utils.synthetic import corridor_pose

    est = np.linalg.inv(m.kf_pose[kf_ids].astype(np.float64))[:, :3, 3]
    gt = np.stack([np.linalg.inv(corridor_pose(i))[:3, 3]
                   for i in range(len(kf_ids))])
    return float(np.sqrt(((est - gt) ** 2).sum(1).mean()))


def pose_graph_cg_ops(K, E_valid, its, iters):
    """Operations of one P' call that ran ``its`` CG iterations in all: the
    start as P's; per LM iteration each valid edge's residual in two
    Dual<7> passes and its blocks and gradient (2254), each chain position's
    pseudo-edge (two compositions, an inverse, two exponentials, its
    residual in two Dual<7> passes), a 7x7 inverse (2n^3/3), M_fwd and
    M_bwd (2 x 2 x 343), the trial cost and the step; per CG iteration the
    matvec (4 x 2 x 49 an edge), the two recurrences and the two A^-1
    applications (2 x 49 a vertex each), three dot products and the vector
    updates (~12 a component)."""
    per_lm = (E_valid * (EDGE_RES * (2 * DUAL7 + 1) + 2254)
              + K * (2 * SIM3_COMPOSE + SIM3_INVERSE + 2 * SIM3_EXP
                     + EDGE_RES * 2 * DUAL7 + 229 + 4 * 343)
              + E_valid * EDGE_RES
              + K * (2 * SIM3_EXP + SIM3_COMPOSE + SIM3_LOG))
    per_cg = E_valid * 4 * 2 * 49 + K * 4 * 2 * 49 + 7 * K * (3 * 2 + 12)
    start = (4 * E_valid * EDGE_RES + K * (7 * SIM3_COMPOSE + 2 * SIM3_INVERSE
                                           + 2 * SIM3_EXP + 2 * SIM3_LOG + 120))
    return start + iters * per_lm + its * per_cg + K * (2 * SIM3_COMPOSE + SIM3_EXP)


def capped_step(a, kw, its):
    """Kernel P''s step in the first LM iteration of ``its`` whose CG met
    its cap, and the plain CG's on the system the kernel linearized there
    (its corrections and damping, read from the workspace of a call that
    stops one LM iteration earlier; P' gives the same result on every
    call): the relative residual ||(H + lam I) v - b|| / ||b|| of each on
    the plain system, beside a float64 CG's on the same float32 blocks.
    Readings, not a check: on an indefinite float32 system the steps of
    both versions are decided by rounding (PERF.md section 7)."""
    from orbslam2_tpu_torch.kernels import pose_graph_cg
    from orbslam2_tpu_torch.ops import pose_graph as pg

    K = a[0].shape[0]
    cap = min(K, 600)
    if cap not in its:
        return "no LM iteration met the CG cap"
    k = its.index(cap)
    pose_graph_cg.optimize_pose_graph(*a, **dict(kw, iters=k))
    st = {n: t.clone() for n, t in pose_graph_cg.last_state.items()}
    pose_graph_cg.optimize_pose_graph(*a, **dict(kw, iters=k + 1))
    v_k = pose_graph_cg.last_state["step"].clone()
    n_k = int(pose_graph_cg.last_cg_iterations[-1])
    _, fixed, valid, ei, ej, Sij, ev = a
    order = kw["order"].long()
    freeze = fixed | ~valid
    x, lam = st["x"], st["lam"]
    Hii, Hjj, Hij, b = pg.edge_blocks(x, ei, ej, st["M_e"], Sij, ev, freeze)
    ch = pg.chain_factor(x, pg.chain_links(st["S0"], order), order, freeze)
    v_p, n_p = pg.cg_solve(Hii, Hjj, Hij, b, ei, ej, lam, freeze, order, *ch)
    v_d, n_d = pg.cg_solve(*(t.double() for t in (Hii, Hjj, Hij, b)), ei, ej,
                           lam.double(), freeze, order, *(t.double() for t in ch))
    H = pg.pair_blocks(Hii, Hjj, Hij).double()

    def residual(v):
        r = pg.matvec(H, v.double(), ei, ej, lam.double(), freeze) - b.double()
        return (r.norm() / b.double().norm()).item()

    return (f"LM iteration {k + 1} (lam {lam.item():.3e}), the first to meet "
            f"the cap: relative residual of P''s step {residual(v_k):.3e} "
            f"({n_k} CG iterations), of the plain CG's {residual(v_p):.3e} "
            f"({n_p}), of a float64 CG's on the same blocks {residual(v_d):.3e} "
            f"({n_d}); step norms {v_k.norm().item():.3e}, "
            f"{v_p.norm().item():.3e}, {v_d.norm().item():.3e}")


def ba_iteration_bound(cam, prob):
    """(ms, "bytes" | "operations") of one LM iteration of kernels E, F'
    (or F), G and H on ``prob``, counted as in ba_rows: E's inputs and its
    system read and written once with its operations per observation, pair
    and landmark; F''s factorization and solves; G's back-substitution and
    cost; H's state."""
    from orbslam2_tpu_torch.kernels import ba_linearize

    K, M = prob.poses.shape[0], prob.points.shape[0]
    lam = torch.full((1,), 1e-4, device=prob.poses.device)
    obs = (prob.point_valid, prob.obs_kf, prob.obs_uvr, prob.obs_sigma2)
    lin = ba_linearize.ba_linearize(cam, prob.poses, prob.points, *obs,
                                    prob.obs_valid, lam, True)
    mask = ba_linearize.effective_mask(prob.obs_kf, prob.obs_valid, prob.point_valid)
    n_obs = int(mask.sum())
    n_pairs = int((mask.sum(1) ** 2).sum())
    n = 6 * K
    n_bytes = (2 * nbytes(prob.poses, prob.points, *obs, prob.obs_valid)
               + 2 * nbytes(*lin) + 2 * nbytes(prob.poses, prob.points))
    n_ops = (680 * n_obs + 216 * n_pairs + 60 * M + cholesky_ops(n) + n * n
             + 200 * K + 75 * n_obs + 21 * M + 3)
    return bound(n_bytes, n_ops)


def pose_graph_cg_launches(dev):
    """Kernel P''s launches by profiler: on the reference's 2000-vertex circle
    a 2- and a 4-iteration call launch the start and the end and then the
    same kernels for every LM iteration (launches_per_iteration), whatever
    its CG iterations: the whole CG solve of an LM iteration is one launch,
    with no host round trip. Run early in the process: late in a long run
    the profiler drops an event or a few from every profile (PERF.md
    section 7)."""
    from orbslam2_tpu_torch.kernels import pose_graph_cg
    from orbslam2_tpu_torch.utils.synthetic import scale_graph

    a, _ = scale_graph("circle")
    a = [torch.from_numpy(x).to(dev) for x in a]
    K = a[0].shape[0]
    per_lm = pose_graph_cg.launches_per_iteration(K)
    seen = []
    for iters in (2, 4):
        expected = 2 + iters * per_lm
        for _ in range(3):
            _, events, _ = device_events(
                lambda: pose_graph_cg.optimize_pose_graph(*a, iters=iters),
                pose_graph_cg.FUNCTION, reps=1)
            if events == expected:
                break
        its = pose_graph_cg.last_cg_iterations.cpu().tolist()
        check(events == expected, f"P' launched {events} kernels in {iters} LM "
              f"iterations, expected {expected} (2 + {iters} x {per_lm})")
        seen.append(f"{iters} iterations (CG {its}): {events} kernels")
    print(f"kernel pose_graph_cg launches (K={K}): " + "; ".join(seen)
          + f"; 2 + {per_lm} an LM iteration, whatever its CG iterations")


def scale_path(dev):
    """Loop closing at map scale on the card: the reference's 1300-keyframe
    global-BA sweep at the RGB-D main path's width and the essential graph
    at n_kf = 1300, each through the LoopCloser's own method, the launch
    counts set to 0 just before and read just after. Returns (counts, the
    captured arguments of P' and of the first window's solve, the "scale"
    line's fields)."""
    from orbslam2_tpu_torch import kernels
    from orbslam2_tpu_torch.kernels import pose_graph_cg
    from orbslam2_tpu_torch.loop_closing import LoopCloser
    from orbslam2_tpu_torch.map.keyframe_database import KeyFrameDatabase
    from orbslam2_tpu_torch.map.state import MapState
    from orbslam2_tpu_torch.models.camera import Camera
    from orbslam2_tpu_torch.ops import sim3_np
    from orbslam2_tpu_torch.utils import slices
    from orbslam2_tpu_torch.utils.convert import map_state_from_numpy
    from orbslam2_tpu_torch.utils.synthetic import (corridor_map, corridor_pose,
                                                    integrate_drift)

    t_phase = time.perf_counter()
    cfg = slices.config("rgbd")
    c = cfg.camera
    cam = Camera.create(c.fx, c.fy, c.cx, c.cy, bf=c.bf, width=c.width,
                        height=c.height)
    t = time.perf_counter()
    m = MapState.allocate(cfg, device=dev)
    kf_ids = corridor_map(m, SCALE_KFS, c.fx, c.fy, c.cx, c.cy, p_new=SCALE_P_NEW,
                          span=SCALE_SPAN, depth=SCALE_DEPTH)
    build_ms = 1e3 * (time.perf_counter() - t)
    # the essential graph's map: a copy taken before the sweep
    snapshot = map_snapshot(m)
    closer = LoopCloser(cfg, m, cam, KeyFrameDatabase(m, device=dev))
    e_pre = rms_centre_error(m, kf_ids)
    e_pre_old = rms_centre_error(m, kf_ids[:SCALE_OLDEST])

    # each window's gather, solve and write-back, synchronised
    marks = []
    windows = []

    def timed(name, fn):
        def wrapped(*a, **k):
            torch.cuda.synchronize()
            marks.append((name, "start", time.perf_counter()))
            r = fn(*a, **k)
            torch.cuda.synchronize()
            marks.append((name, "end", time.perf_counter()))
            if name == "gather" and r is not None:
                windows.append(dict(K=len(r[1]), M=int(r[4]), prob=r[0]))
            if name == "solve" and len(windows) == 1:
                windows[0].update(args=(a, k), result=r)
            return r
        return wrapped

    closer._gba_gather = timed("gather", closer._gba_gather)
    closer._solve_chunked = timed("solve", closer._solve_chunked)
    closer._propagate_unoptimized = timed("propagate", closer._propagate_unoptimized)
    out = io.StringIO()
    kernels.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        closer.global_bundle_adjustment(obs_cap=SCALE_SPAN)
    torch.cuda.synchronize()
    sweep_ms = 1e3 * (time.perf_counter() - t)
    printed = out.getvalue()
    print(printed, end="")
    e_post = rms_centre_error(m, kf_ids)
    e_post_old = rms_centre_error(m, kf_ids[:SCALE_OLDEST])
    # per window: gather, solve, and the write-back (the solve's end to the
    # next gather or the propagation)
    times = {"gather": [], "solve": [], "write_back": [], "propagate": []}
    for i, (name, edge, at) in enumerate(marks):
        if edge == "end":
            start = next(s for n, e, s in reversed(marks[:i]) if n == name and e == "start")
            times[name].append(1e3 * (at - start))
            if name == "solve":
                times["write_back"].append(1e3 * (marks[i + 1][2] - at))

    # the essential graph at n_kf = 1300: the stored poses drifted along the
    # chain (each odometry link moved by SCALE_DRIFT along z), a loop edge
    # from the last keyframe to the first, the last keyframe's corrected
    # pose its true one
    m2 = map_state_from_numpy(cfg, snapshot, device=dev)
    S = sim3_np.from_se3(m2.kf_pose[kf_ids].astype(np.float32))
    links = sim3_np.compose(S[1:], sim3_np.inverse(S[:-1])).astype(np.float32)
    drift = np.zeros(7, np.float32)
    drift[2] = SCALE_DRIFT
    m2.kf_pose[kf_ids] = sim3_np.to_se3(integrate_drift(links, S[0], drift))
    first, last = kf_ids[0], kf_ids[-1]
    m2.loop_edges.append((last, first))
    m2.dev_kf.ensure(m2)   # the keyframe mirror a running system keeps
    closer2 = LoopCloser(cfg, m2, cam, KeyFrameDatabase(m2, device=dev))
    true_last = corridor_pose(SCALE_KFS - 1)
    c_true = np.linalg.inv(true_last)[:3, 3]
    e_pg0 = float(np.linalg.norm(np.linalg.inv(m2.kf_pose[last])[:3, 3] - c_true))
    pg_ms = defaultdict(float)
    with Capture(pose_graph_cg, "optimize_pose_graph") as cap, \
            Stopwatch(pg_ms, "P'", pose_graph_cg, "optimize_pose_graph"):
        torch.cuda.synchronize()
        t = time.perf_counter()
        closer2._optimize_essential_graph(
            last, first, {}, {last: sim3_np.from_se3(true_last)})
        torch.cuda.synchronize()
        eg_ms = 1e3 * (time.perf_counter() - t)
    counts = kernels.launch_counts()
    e_pg = float(np.linalg.norm(np.linalg.inv(m2.kf_pose[last])[:3, 3] - c_true))
    its = pose_graph_cg.last_cg_iterations.cpu().tolist()
    pg_args = cap.args
    phase_s = time.perf_counter() - t_phase

    check("sweep:" in printed and "newest window" not in printed,
          f"scale: the sweep did not run: {printed!r}")
    check(np.isfinite(m.kf_pose[kf_ids]).all(), "scale: poses not finite")
    check(e_post < SCALE_GAIN * e_pre, f"scale: sweep error {e_post} not < "
          f"{SCALE_GAIN} x {e_pre}")
    check(e_post_old < SCALE_GAIN * e_pre_old, f"scale: oldest {SCALE_OLDEST} "
          f"error {e_post_old} not < {SCALE_GAIN} x {e_pre_old}")
    check(np.isfinite(m2.kf_pose[kf_ids]).all(), "scale: graph poses not finite")
    check(e_pg < PG_GAIN * e_pg0, f"scale: essential graph far end {e_pg} "
          f"not < {PG_GAIN} x {e_pg0}")
    fields = dict(
        keyframes=SCALE_KFS, points=int(len(m.valid_map_points())),
        windows=len(windows), window_K=[w["K"] for w in windows],
        window_M=[w["M"] for w in windows], obs_cap=SCALE_SPAN,
        rms_error=dict(before=e_pre, after=e_post, oldest_before=e_pre_old,
                       oldest_after=e_post_old),
        essential_graph=dict(K=int(pg_args[0][0].shape[0]),
                             E=int(pg_args[0][3].shape[0]),
                             far_end_before=e_pg0, far_end_after=e_pg,
                             cg_iterations=its),
        ms=dict(map_build_host=build_ms, sweep=sweep_ms, gather=times["gather"],
                solve=times["solve"], write_back=times["write_back"],
                propagate=times["propagate"], essential_graph=eg_ms,
                pose_graph_cg_wall=1e3 * pg_ms["P'"]),
        phase_s=phase_s, card=card_line())
    return counts, dict(pg=pg_args, window=windows[0], windows=windows,
                        cam=cam, closer_solve=closer._solve_chunked), fields


# the async phase's bounds: tests/test_pipeline.py's (>= 28 of 30 frames in
# the trajectory, scaled to 36; ATE < 0.08 m; >= 3 keyframes) and the async
# circuit of tests/test_loop_e2e.py (a loop closes, finite poses, keyframe
# ATE < 0.2 m, a wait while 3 keyframes queue)
ASYNC_TRACKED = 34
ASYNC_ATE = 0.08
ASYNC_LOOP_ATE = 0.2
ASYNC_RUNS = 3
# kernel R''s operations a motion-model call: two orthonormalizations (40
# each), the rigid inverse (18), two 4x4 products (112 each)
POSE_CHAIN_OPS = 2 * 40 + 18 + 2 * 112


def async_rgbd(dev, frames, poses, sync_fps):
    """(a) phase 4's 36 RGB-D frames (640x480, 1000 features, 8 levels)
    through AsyncSlamSystem (pipelined tracking, default depths), then
    shutdown(), to tests/test_pipeline.py's bounds scaled to 36 frames.
    Returns (counts, the captured chained-cascade calls with and without
    the motion model)."""
    from orbslam2_tpu_torch import kernels, tracking
    from orbslam2_tpu_torch.pipeline import AsyncSlamSystem
    from orbslam2_tpu_torch.utils import slices
    from orbslam2_tpu_torch.utils.evaluation import ate_rmse

    slam = AsyncSlamSystem(slices.config("rgbd"), device=dev)
    kernels.reset_launches()
    calls = []
    with Capture(tracking, "track_frame_fused_chained", lambda a, k: a[3]) as motion, \
            Capture(tracking, "track_frame_fused_chained", lambda a, k: not a[3]) as still:
        t0 = time.perf_counter()
        for i, frame in enumerate(frames):
            t1 = time.perf_counter()
            slices.track(slam, "rgbd", frame, i / 30.0)
            calls.append(time.perf_counter() - t1)
        slam.shutdown()
        wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    traj = slam.tracker.trajectory
    est = np.array([np.linalg.inv(T)[:3, 3] for _, _, T in traj])
    gt = np.array([np.linalg.inv(poses[f])[:3, 3] for f, _, _ in traj])
    ate = ate_rmse(est, gt, with_scale=False)
    n_kf = len(slam.map.valid_keyframes())
    print(f"async rgbd (AsyncSlamSystem, pipelined, depths "
          f"{slam.cfg.runtime.pipeline_depth}/{slam.cfg.runtime.pipeline_depth_max}, "
          f"{len(frames)} frames of 640x480): {len(traj)} in the trajectory, "
          f"{n_kf} keyframes, ATE {ate:.5f} m; {len(frames) / wall:.2f} frames/s "
          f"from the first call to shutdown's end ({1e3 * statistics.median(calls):.2f} "
          f"ms the median call) against the synchronous path's {sync_fps:.2f} "
          f"(phase 4); launches {counts}")
    check(len(traj) >= ASYNC_TRACKED, f"async rgbd: {len(traj)} frames tracked")
    check(ate < ASYNC_ATE, f"async rgbd: ATE {ate} >= {ASYNC_ATE}")
    check(n_kf >= 3, f"async rgbd: only {n_kf} keyframes")
    check(motion.args is not None and still.args is not None,
          "async rgbd: the chained cascade ran without both prediction kinds")
    return counts, (motion, still)


def async_circuit(dev, run):
    """(c) the loop circuit (utils/slices.circuit, 240 frames at 320x240)
    through AsyncSlamSystem with background global BA, fed with
    tests/test_loop_e2e.py's back-pressure, to its bounds. Returns (counts,
    the "async" line's fields of the run, kernel M's LM arguments)."""
    from orbslam2_tpu_torch import kernels
    from orbslam2_tpu_torch.kernels import sim3_opt
    from orbslam2_tpu_torch.pipeline import AsyncSlamSystem
    from orbslam2_tpu_torch.utils import slices

    frames, poses = slices.circuit()
    slam = AsyncSlamSystem(slices.config("circuit"), device=dev)
    closer = slam.loop_closer
    busy, gba_runs = [], []  # (start, end) of closures and GBA runs
    correct, gba_task = closer._compute_and_correct, closer._gba_task

    def timed_correct(*a, **k):
        t = time.perf_counter()
        try:
            return correct(*a, **k)
        finally:
            busy.append((t, time.perf_counter()))

    def timed_gba():
        t = time.perf_counter()
        gba_task()
        busy.append((t, time.perf_counter()))
        gba_runs.append(dict(ms=1e3 * (time.perf_counter() - t),
                             superseded=closer.gba_abort.is_set()))

    closer._compute_and_correct, closer._gba_task = timed_correct, timed_gba
    calls, depth_max, first_close = [], 0, None
    kernels.reset_launches()
    with Capture(sim3_opt, "optimize_sim3") as m_opt:
        for i, (img, depth) in enumerate(frames):
            t1 = time.perf_counter()
            slam.track_rgbd(img, depth, i / 30.0)
            calls.append((t1, time.perf_counter()))
            depth_max = max(depth_max, slam._kf_queue.qsize())
            if first_close is None and closer.loops_closed:
                first_close = i
            waited = 0.0
            while slam._kf_queue.qsize() >= 3 and waited < 5.0:
                time.sleep(0.01)
                waited += 0.01
        slam.shutdown()
    counts = kernels.launch_counts()
    ate = slices.keyframe_ate(slam, poses)
    kfs = slam.map.valid_keyframes()
    during = [e - s for s, e in calls if any(b0 < e and b1 > s for b0, b1 in busy)]
    fields = dict(run=run, frame=first_close, loops=closer.loops_closed,
                  keyframe_ate=ate, keyframes=len(kfs), gba=gba_runs,
                  kf_queue_max=depth_max, fuse_ba_skips=slam.local_mapper.skipped,
                  track_ms_max_during_closure_or_gba=1e3 * max(during, default=0.0),
                  track_ms_max=1e3 * max(e - s for s, e in calls),
                  track_ms_median=1e3 * statistics.median(e - s for s, e in calls))
    print("async " + json.dumps(fields))
    check(closer.loops_closed >= 1, f"async circuit {run}: no loop closed")
    check(np.isfinite(slam.map.kf_pose[kfs]).all(), f"async circuit {run}: poses")
    check(ate is not None and ate < ASYNC_LOOP_ATE,
          f"async circuit {run}: keyframe ATE {ate} >= {ASYNC_LOOP_ATE}")
    return counts, fields, m_opt.args


def pipelined_frame_kernels(dev, frames):
    """(b) A Tracker driven by track_pipelined on the RGB-D frames with no
    mapping; one call whose frame makes no keyframe and whose local map is
    the cached one is profiled: its device work must be only kernels I, A,
    J, B, L, R', O, C, Q, D, R, the feature buffer's fill, memsets and the
    uploads, with exactly one device-to-host copy (into pinned memory), and
    no stream or device synchronize beyond those of a profile of no work
    (the profiler's own and the one after the call)."""
    from orbslam2_tpu_torch.kernels import (cascade_pack, claim_resolve, describe,
                                            fast_score, hamming, orb_select,
                                            pose_chain, pose_lm, project_gate,
                                            pyramid, rgbd_depth)
    from orbslam2_tpu_torch.map.state import MapState
    from orbslam2_tpu_torch.tracking import Tracker
    from orbslam2_tpu_torch.utils import slices

    cfg = slices.config("rgbd")
    tr = Tracker(cfg, MapState.allocate(cfg, device=dev), device=dev)
    allowed = [m.FUNCTION for m in (pyramid, fast_score, orb_select, describe,
                                    rgbd_depth, pose_chain, project_gate, hamming,
                                    claim_resolve, pose_lm, cascade_pack)] \
        + ["FillFunctor", "Memset", "Memcpy HtoD"]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    def profiled(fn):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        return prof.key_averages()

    def synchronizations(ev):
        return {e.key: e.count for e in ev if "Synchronize" in e.key}

    base = synchronizations(profiled(lambda: None))
    for i, (img, depth) in enumerate(frames):
        n_kf, key = len(tr.pending_keyframes), tr._local_cache_key
        if i < 4:
            tr.track_pipelined(img, i / 30.0, depth_map=depth)
            continue
        ev = profiled(lambda: tr.track_pipelined(img, i / 30.0, depth_map=depth))
        if len(tr.pending_keyframes) == n_kf and tr._local_cache_key == key:
            break
    else:
        check(False, "pipelined frame: every call made a keyframe or a new local map")
    dev_counts = {e.key: e.count for e in ev
                  if e.device_type == torch.autograd.DeviceType.CUDA}
    runtime = {e.key: e.count for e in ev if e.key.startswith("cuda")}
    d2h = {k: n for k, n in dev_counts.items() if "DtoH" in k}
    other = sorted(k for k in dev_counts
                   if "DtoH" not in k and not any(a in k for a in allowed))
    syncs = synchronizations(ev)
    print(f"pipelined frame {i} on the card, all its device work: "
          f"{sum(dev_counts.values())} events, " + ", ".join(sorted(dev_counts))
          + f"; synchronizations {syncs} (a profile of no work: {base}); "
          f"runtime calls {runtime}")
    check(not other, f"the pipelined frame launched other device work: {other}")
    check(sum(d2h.values()) == 1 and all("Pinned" in k for k in d2h),
          f"the pipelined frame made device-to-host copies {d2h}, not one into "
          f"pinned memory")
    check(runtime.get("cudaLaunchKernel", 0) > 0,
          "the profile recorded no CUDA runtime calls")
    for kind in ("cudaStreamSynchronize", "cudaDeviceSynchronize"):
        check(syncs.get(kind, 0) == base.get(kind, 0),
              f"the pipelined frame synchronized the stream or the device: "
              f"{syncs} against {base}")
    return i


def pose_chain_rows(dev, record, captures):
    """(d) Kernel R' against its plain version on the links recorded in
    (a), within 1e-6 (both kinds of prediction and the next link); the
    chained cascade against the plain chained cascade on the recorded
    calls, as phase 3 holds the cascade (pose 1e-4, counts within 1%,
    codes >= 99% equal, the share printed) and the next link within 1e-4.
    R''s row."""
    from orbslam2_tpu_torch import tracking
    from orbslam2_tpu_torch.kernels import pose_chain

    errs = []
    for cap in captures:
        (a, kw), (packed, _) = cap.args, cap.result
        links = ((a[1], a[2], a[3]), (packed[:16].view(4, 4), None, False))
        for la in links:
            errs.append((pose_chain.pose_chain(*la)
                         - pose_chain.pose_chain_plain(*la)).abs().max().item())
        pk, Tk = tracking.track_frame_fused_chained(*a, **kw)
        pp, Tp = tracking.track_frame_fused_chained(*a, plain=True, **kw)
        err = (pk[:16] - pp[:16]).abs().max().item()
        counts_ok = all(abs(pk[i].item() - pp[i].item()) <= max(0.01 * pp[i].item(), 1)
                        for i in range(16, 20))
        codes = (pk[20:] == pp[20:]).float().mean().item()
        err_t = (Tk - Tp).abs().max().item()
        print(f"chained cascade (motion model {a[3]}): pose max diff {err:.2e}, "
              f"counts {[int(v) for v in pk[16:20].tolist()]} vs "
              f"{[int(v) for v in pp[16:20].tolist()]}, codes equal {codes:.5f}, "
              f"next link {err_t:.2e}")
        check(err <= 1e-4 and counts_ok and codes >= 0.99 and err_t <= 1e-4,
              f"chained cascade (motion {a[3]}): pose {err}, counts "
              f"{pk[16:20].tolist()} vs {pp[16:20].tolist()}, codes {codes}, "
              f"link {err_t}")
    err_r = max(errs)
    check(err_r <= 1e-6, f"kernel R' differs from its plain version by {err_r}")
    a = captures[0].args[0]
    la = (a[1], a[2], True)
    record(pose_chain, err_r, lambda: pose_chain.pose_chain(*la),
           cuda_ms(lambda: pose_chain.pose_chain_plain(*la)),
           f"the links of the async RGB-D run: prediction with and without the "
           f"motion model and the next link, max diff {err_r:.2e}",
           # two links read, the prediction written
           n_bytes=3 * 64, n_ops=POSE_CHAIN_OPS)


def async_path(dev, record, frames, poses, sync_fps):
    """Phase 9: the asynchronous system. (a) the RGB-D frames and (c) the
    loop circuit three times through AsyncSlamSystem, their launch counts
    set to 0 before each run and read after its shutdown() joined the
    workers; (b) one pipelined frame by profiler; (d) kernel R' and the
    chained cascade against their plain versions, and kernel M's LM on each
    circuit run's arguments. Returns the path's summed counts."""
    counts, captures = async_rgbd(dev, frames, poses, sync_fps)
    total = defaultdict(int, counts)
    m_args = []
    for run in range(ASYNC_RUNS):
        c, _, m = async_circuit(dev, run)
        m_args.append(m)
        for k, v in c.items():
            total[k] += v
    pipelined_frame_kernels(dev, frames)
    pose_chain_rows(dev, record, captures)
    for run, m in enumerate(m_args):
        if m is not None:
            sim3_lm_check(f"async circuit {run}", *m)
    return dict(total)


def scale_rows(dev, record, args, fields):
    """Kernel P' against its plain version on the reference's two
    2000-vertex graphs, on a 385-keyframe ring against kernel P forced
    dense, and on the arguments the scale path gave it (the kernels line's
    row); the sweep's first window against the plain BA schedule; and the
    sweep's bounds. Adds P''s device ms to ``fields``."""
    from orbslam2_tpu_torch.kernels import pose_graph, pose_graph_cg
    from orbslam2_tpu_torch.ops import ba
    from orbslam2_tpu_torch.ops import geometry as geo
    from orbslam2_tpu_torch.utils import ba_parity
    from orbslam2_tpu_torch.utils.synthetic import pose_graph_ring, scale_graph

    # (a) the reference's 2000-vertex graphs, with the reference tests'
    # assertions; the circle also against the plain CG on the card. The
    # corridor's CG meets its 600-iteration cap in every LM iteration, where
    # its float32 system is indefinite and the step decided by rounding
    # (PERF.md section 7), so there the kernel is held to the reference's
    # assertions, and on both graphs, with PG_PARITY_CG iterations a solve,
    # to the plain version
    for kind in ("circle", "corridor"):
        a, S_true = scale_graph(kind)
        a = [torch.from_numpy(x).to(dev) for x in a]
        S_true = torch.from_numpy(S_true).to(dev)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        rk = pose_graph_cg.optimize_pose_graph(*a)
        ev[1].record()
        ev[1].synchronize()
        ms_k = ev[0].elapsed_time(ev[1])
        its = pose_graph_cg.last_cg_iterations.cpu().tolist()
        e0 = (centre(a[0][-1]) - centre(S_true[-1])).norm().item()
        err = (centre(rk.poses[-1]) - centre(S_true[-1])).norm().item()
        log_s = geo.sim3_s(rk.poses).log().abs().max().item()
        check(bool(torch.isfinite(rk.poses).all()), f"P' {kind}: not finite")
        check(err < PG_GAIN * e0, f"P' {kind}: far end {err} not < {PG_GAIN} x {e0}")
        vs_plain = ""
        if kind == "circle":
            t = time.perf_counter()
            rp = pose_graph_cg.optimize_pose_graph_plain(*a)
            torch.cuda.synchronize()
            ms_p = 1e3 * (time.perf_counter() - t)
            diff = (rk.poses - rp.poses).abs().max().item()
            check(diff < PG_TOL, f"P' circle: pose vectors differ by {diff}")
            vs_plain = (f", pose vectors vs plain max diff {diff:.3e}, cost "
                        f"{rk.cost.item():.3e} vs {rp.cost.item():.3e}, plain "
                        f"{ms_p:.1f} ms")
        else:
            check(log_s < 0.05, f"P' corridor: |log s| {log_s} >= 0.05")
        diff1 = (pose_graph_cg.optimize_pose_graph(*a, max_cg=PG_PARITY_CG).poses
                 - pose_graph_cg.optimize_pose_graph_plain(
                     *a, max_cg=PG_PARITY_CG).poses).abs().max().item()
        check(diff1 < PG_TOL, f"P' {kind}, {PG_PARITY_CG} CG iteration a solve: "
              f"pose vectors differ from the plain version's by {diff1}")
        print(f"kernel pose_graph_cg on the reference's 2000-vertex {kind} "
              f"(E={a[3].shape[0]}): far end {e0:.4f} m -> {err:.3e} m, max "
              f"|log s| {log_s:.2e}{vs_plain}; {ms_k:.1f} ms a call between "
              f"CUDA events; CG iterations {its}; with {PG_PARITY_CG} CG "
              f"iteration a solve, pose vectors vs plain max diff {diff1:.3e}")

    # (b) P' against P forced dense at the loop circuit's size, at the
    # dense limit and one past it
    for K in (65, 384, 385):
        a, _ = pose_graph_ring(K)
        a = [x.to(dev) for x in a]
        rd = pose_graph.optimize_pose_graph(*a, fix_scale=True, solver="dense")
        rc = pose_graph.optimize_pose_graph(*a, fix_scale=True, solver="cg")
        diff = (rd.poses - rc.poses).abs().max().item()
        check(diff < PG_TOL, f"P' at K={K}: pose vectors differ from P's by {diff}")
        ms = {"dense": [], "cg": []}
        for solver in ("dense", "cg", "cg", "dense"):
            ms[solver].append(cuda_ms(
                lambda: pose_graph.optimize_pose_graph(*a, fix_scale=True,
                                                       solver=solver),
                reps=3, warmup=1))
        print(f"pose graph at K={K} (ring, E={a[3].shape[0]}): P' vs P dense "
              f"max diff {diff:.3e}; ms a call, alternating P, P', P', P: "
              f"P {ms['dense']}, P' {ms['cg']}")

    # the main path's P' call: the row and its memory (its launches per LM
    # iteration are checked in phase 3, pose_graph_cg_launches), the same
    # result on a second call, and the plain version with PG_PARITY_CG CG
    # iterations a solve. From the third LM iteration its CG meets the
    # 600-iteration cap on an indefinite float32 system, so the steps of
    # both versions there are read as their relative residuals on the plain
    # system, beside a float64 CG's on the same float32 blocks
    a, kw = args["pg"]
    a, kw = a[:7], {**dict(zip(("iters", "fix_scale", "order"), a[7:])), **kw}
    K, E, E_valid = a[0].shape[0], a[3].shape[0], int(a[6].sum())
    iters = kw["iters"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    rk = pose_graph_cg.optimize_pose_graph(*a, **kw)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    its = pose_graph_cg.last_cg_iterations.cpu().tolist()
    dense = 4 * (7 * K) ** 2
    check(peak < dense // 8, f"P' allocated {peak} bytes, dense system {dense}")
    again = pose_graph_cg.optimize_pose_graph(*a, **kw)
    check(torch.equal(rk.poses, again.poses), "P' on the loop closer's graph: "
          "a second call gave another result")
    t = time.perf_counter()
    rp = pose_graph_cg.optimize_pose_graph_plain(*a, **kw)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t)
    err_c, err_r = pose_diff(rk.poses, rp.poses, a[2])
    diff = (pose_graph_cg.optimize_pose_graph(*a, **kw, max_cg=PG_PARITY_CG).poses
            - pose_graph_cg.optimize_pose_graph_plain(
                *a, **kw, max_cg=PG_PARITY_CG).poses).abs().max().item()
    check(diff < PG_TOL, f"P' on the loop closer's graph, {PG_PARITY_CG} CG "
          f"iteration a solve: pose vectors differ by {diff}")
    capped = capped_step(a, kw, its)
    n = 7 * K
    g = torch.Generator(device=dev).manual_seed(2)
    B = torch.randn(n, n, device=dev, generator=g)
    A_spd = B @ B.T / n + torch.eye(n, device=dev)
    rhs = torch.randn(n, 1, device=dev, generator=g)
    row = record(pose_graph_cg, diff, lambda: pose_graph_cg.optimize_pose_graph(*a, **kw),
                 plain_ms,
                 f"the loop closer's graph, K={K} slots ({int(a[2].sum())} live), "
                 f"E={E}, {iters} iterations, CG iterations {its} ({sum(its)} "
                 f"in all), a second call bit-identical; {PG_PARITY_CG} CG "
                 f"iteration a solve against the plain CG: pose vectors max diff "
                 f"{diff:.2e}; {capped}; {iters} iterations: centres "
                 f"max diff {err_c:.2e} m, rotations {err_r:.2e} rad, cost "
                 f"{rk.cost.item():.3e} vs {rp.cost.item():.3e}; peak "
                 f"allocation {peak / 2**20:.1f} MiB against the dense system's "
                 f"{dense / 2**20:.1f} MiB; library: torch.linalg.cholesky + "
                 f"torch.cholesky_solve of one n={n} system (one LM iteration's "
                 f"dense solve)",
                 library_ms=cuda_ms(lambda: torch.cholesky_solve(
                     rhs, torch.linalg.cholesky(A_spd)), reps=5),
                 function=None, reps=1,
                 # the graph read once, the poses written; operations of the
                 # run's CG iterations (pose_graph_cg_ops)
                 n_bytes=nbytes(*a, kw["order"]) + 4 * (8 * K + 1),
                 n_ops=pose_graph_cg_ops(K, E_valid, sum(its), iters))
    fields["essential_graph"]["device_ms"] = row["device_ms"]

    # the sweep's first window: the kernels' chunked solve against the
    # plain BA schedule run the same way, each reading held to its fixed
    # limit in SWEEP_LIMITS; a control, the plain schedule with its last LM
    # iteration dropped, must exceed every limit it is held to, in this run
    win = args["window"]
    closer_prob, w_iters, _, chunk = win["args"][0]
    cam = args["cam"]

    def plain_schedule(total):
        prob, done, res = closer_prob, 0, None
        while done < total:
            n_it = min(chunk, total - done)
            res = ba.optimize_ba_plain(cam, prob, iters=n_it,
                                       outlier_rounds=1 if done + n_it >= total else 0)
            prob = prob._replace(poses=res.poses, points=res.points)
            done += n_it
        return res

    res_p = plain_schedule(w_iters)
    got = ba_parity.compare(cam, closer_prob, win["result"], res_p)
    control = ba_parity.compare(cam, closer_prob, plain_schedule(w_iters - 1), res_p)
    # the kernels against themselves: a second run of the chunked solve
    again = args["closer_solve"](closer_prob, w_iters, None, chunk)
    spread = ba_parity.compare(cam, closer_prob, again, win["result"])
    print(f"scale: the sweep's first window (K={win['K']}, M={win['M']}, O="
          f"{SCALE_SPAN}, {w_iters} iterations in chunks of {chunk}) against the "
          f"plain schedule: {got}; the kernels' second run against their "
          f"first: {spread}; control, the plain schedule with {w_iters - 1} "
          f"iterations against {w_iters}: {control}; limits {SWEEP_LIMITS}; "
          f"cost {win['result'].cost.item():.6f} vs plain {res_p.cost.item():.6f}")
    over = {k: got[k] for k, lim in SWEEP_LIMITS.items() if got[k] > lim}
    check(not over, f"scale: first window {over} over {SWEEP_LIMITS}")
    blind = {k: control[k] for k in SWEEP_CONTROLLED if control[k] <= SWEEP_LIMITS[k]}
    check(not blind, f"scale: the control {blind} does not exceed {SWEEP_LIMITS}")
    # the sweep's row (K9''): a window's device time (the first window's
    # chunked solve, profiled), and the windows' E-F'-G-H bounds over the
    # LM iterations of the chunked schedule (each chunk's iterations, the
    # last chunk's outlier round half as many again)
    window_dev = device_ms(lambda: args["closer_solve"](closer_prob, w_iters, None,
                                                        chunk), None, reps=1)
    lm_its, done = 0, 0
    while done < w_iters:
        n_it = min(chunk, w_iters - done)
        done += n_it
        lm_its += n_it + (max(n_it // 2, 1) if done >= w_iters else 0)
    bounds = [ba_iteration_bound(cam, w["prob"]) for w in args["windows"]]
    fields["window_bound_ms_per_lm_iteration"] = [b[0] for b in bounds]
    fields["windows_bound_ms"] = lm_its * sum(b[0] for b in bounds)
    fields["first_window_device_ms"] = window_dev
    fields["first_window_parity"] = got
    fields["first_window_kernel_spread"] = spread
    fields["first_window_control"] = control
    print(f"sweep (K9''): {fields['ms']['sweep']:.1f} ms for {len(bounds)} windows, "
          f"the first window's solve {window_dev:.3f} ms of device "
          f"({lm_its} LM iterations), the windows' E-H bounds "
          f"{fields['windows_bound_ms']:.4f} ms in all")


# ---------------------------------------------------------------------------
# Phase 10: vocabulary training and the dataset surfaces
# ---------------------------------------------------------------------------

ROOT = os.path.dirname(os.path.abspath(__file__))
Y_TRAINING = "bow_words_training"   # kernel Y's row at training shape


def vocab_path(dev):
    """(b) the asset tool's corpus (tools/train_default_vocab.py: 12 rooms x
    14 views and 8 corridors x 16 views at 640x480, 1500 features, 8
    levels) rendered, extracted on the card, trained to W = 65536 words in 4
    iterations on kernels Y and Y' with IDF; the counts set to 0 just before
    the training and read just after; then the plain trainer on the card
    on the same descriptors: centres and IDF bit-exact. If the render's
    projected time would take the phase past VOCAB_PHASE_S, the corpus is
    cut to its first VOCAB_CUT images, and the line says so. Returns
    (counts, the first iteration's arguments, fields)."""
    from orbslam2_tpu_torch import kernels
    from orbslam2_tpu_torch.device import upload
    from orbslam2_tpu_torch.ops import bow
    from orbslam2_tpu_torch.tools import train_default_vocab as tool

    t_phase = time.perf_counter()
    workers = max(1, min(8, os.cpu_count() or 1))
    todo = tool.scenes()
    t0 = time.perf_counter()
    images = tool.render_scene(todo[0])
    t_first = time.perf_counter() - t0
    projected = t_first * (1 + (len(todo) - 1) / workers)
    cut = projected > VOCAB_PHASE_S / 2
    if cut:
        need = -(-(VOCAB_CUT - len(images)) // tool.CORRIDOR_VIEWS)
        images = (images + tool.render_scenes(todo[1:1 + need], workers))[:VOCAB_CUT]
    else:
        images = images + tool.render_scenes(todo[1:], workers)
    render_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    desc, valid, docs = tool.extract_corpus(images, dev)
    extract_s = time.perf_counter() - t0
    n_desc = int(valid.sum())
    check(n_desc >= bow.VOCAB_SIZE, f"vocab: {n_desc} descriptors < W")
    timings = []
    kernels.reset_launches()
    bits, idf = tool.train(desc, valid, docs, device=dev, timings=timings)
    counts = kernels.launch_counts()
    t0 = time.perf_counter()
    bits_p, idf_p = tool.train(desc, valid, docs, device=dev, plain=True)
    plain_s = time.perf_counter() - t0
    check(np.array_equal(bits, bits_p), "vocab: the trained centres differ from "
          f"the plain trainer's at {int((bits != bits_p).sum())} bits")
    check(np.array_equal(idf, idf_p), "vocab: IDF differs from the plain trainer's")
    seen = int((idf < np.log(len(images))).sum())
    # the first iteration's arguments: the packed descriptors, the
    # reference's start and its words
    d = desc.reshape(-1, 32)[valid.reshape(-1)]
    rng = np.random.default_rng(7)
    d_dev = upload(d, dev)
    start = upload(d[rng.choice(len(d), bow.VOCAB_SIZE, replace=False)], dev)
    words = bow.assign_packed(d_dev, start, plain=True)
    fields = dict(
        images=len(images), cut_to_first=VOCAB_CUT if cut else None,
        render_workers=workers, descriptors=n_desc, words=bow.VOCAB_SIZE,
        words_seen=seen, idf_range=[float(idf.min()), float(idf.max())],
        render_s=render_s, extract_s=extract_s,
        assign_ms=[t for name, _, t in timings if name == "assign"],
        update_ms=[t for name, _, t in timings if name == "update"],
        idf_ms=[t for name, _, t in timings if name == "idf"][0],
        plain_trainer_s=plain_s, centres_vs_plain="bit-exact",
        vocab_launches={k: v for k, v in counts.items() if v})
    fields["vocab_phase_s"] = time.perf_counter() - t_phase
    print(f"vocab: {len(images)} images{' (cut: the render would take the phase past %.0f s)' % VOCAB_PHASE_S if cut else ''}, "
          f"{n_desc} descriptors -> {bow.VOCAB_SIZE} words, {seen} seen in training; "
          f"render {render_s:.2f} s ({workers} processes), extraction {extract_s:.2f} s, "
          f"assign {', '.join(f'{t:.2f}' for t in fields['assign_ms'])} ms, update "
          f"{', '.join(f'{t:.2f}' for t in fields['update_ms'])} ms, IDF "
          f"{fields['idf_ms']:.2f} ms; the plain trainer on the card {plain_s:.2f} s, "
          f"centres and IDF bit-exact; launches {fields['vocab_launches']}")
    return counts, (d_dev, start, words), fields


def vocab_rows(dev, record, args, fields):
    """(a) kernels Y (words only) and Y' against their plain versions at W =
    65536 and the corpus's N, on the first training iteration's arguments:
    words, counts, sums and centres bit-exact; their rows."""
    from orbslam2_tpu_torch.kernels import bow_words, vocab_update
    from orbslam2_tpu_torch.ops import matching

    d, start, words_p = args
    N, Wn = d.shape[0], start.shape[0]
    valid = torch.ones(N, dtype=torch.bool, device=dev)
    words_k = bow_words.bow_words(d, valid, start, vector=False)[0]
    check(torch.equal(words_k, words_p), "kernel Y at training shape: words "
          f"differ at {int((words_k != words_p).sum())} of {N}")
    y_bytes = nbytes(d, valid, start) + (8 + 8 + 4) * N
    library_y = hamming_library(d, start)
    check(torch.equal(library_y().int(), words_p), "the library's words differ")
    row = record(bow_words, 0.0,
                 lambda: bow_words.bow_words(d, valid, start, vector=False),
                 cuda_ms(lambda: bow_words.bow_words_plain(d, valid, start,
                                                           vector=False), reps=2, warmup=1),
                 f"training shape N={N} x W={Wn}, words only: bit-exact; bound: "
                 f"the {N} x {Wn} x 256 bit product on the int8 tensor cores; "
                 f"library: the float16 product of the bits (one addmm) + argmin "
                 f"in chunks of 16384 rows",
                 n_bytes=y_bytes, n_ops=0,
                 library_ms=cuda_ms(library_y, reps=2, warmup=1), per_call=2,
                 bound_override=hamming_bound(N, Wn, y_bytes), reps=3, batched=True)
    row.update(name=Y_TRAINING, replaces="orbslam2_tpu/ops/bow.py:135")
    del library_y

    ck, sk, nk = vocab_update.vocab_update(d, words_p, start)
    cp, sp, np_ = vocab_update.vocab_update_plain(d, words_p, start)
    check(torch.equal(ck, cp) and torch.equal(sk, sp) and torch.equal(nk, np_),
          "kernel Y' not bit-exact: counts "
          f"{int((ck != cp).sum())}, sums {int((sk != sp).sum())}, centres "
          f"{int((nk != np_).sum())} differ")
    n_empty = int((ck == 0).sum())
    bits_f = matching.unpack_bits(d).float()
    idx = words_p.long()

    def library_u():
        sums = torch.zeros((Wn, 256), device=dev).index_add_(0, idx, bits_f)
        cnt = torch.zeros(Wn, device=dev).index_add_(
            0, idx, torch.ones(N, device=dev))
        vote = sums / cnt.clamp_min(1.0)[:, None] > 0.5
        return torch.where((cnt > 0)[:, None], vote, matching.unpack_bits(start).bool())

    check(torch.equal(library_u(), matching.unpack_bits(nk).bool()),
          "the library's vote differs")
    record(vocab_update, 0.0, lambda: vocab_update.vocab_update(d, words_p, start),
           cuda_ms(lambda: vocab_update.vocab_update_plain(d, words_p, start),
                   reps=3, warmup=1),
           f"N={N} x W={Wn} ({n_empty} empty words): counts, sums and centres "
           f"bit-exact; library: index_add_ of the unpacked float bits and the "
           f"counts + the vote",
           # read once: the packed descriptors, their words and the old
           # centres; written once: counts, sums and the new centres
           n_bytes=nbytes(d, words_p, start, ck, sk, nk),
           n_ops=N * 256 + Wn * 256 * 2,
           library_ms=cuda_ms(library_u, reps=3, warmup=1), per_call=2, reps=5,
           batched=True)
    fields["first_iteration_empty_words"] = n_empty


def run_cli(module, *args, timeout=600):
    """``python -m module args`` from the checkout's root; its stdout, or a
    failure with the end of its stderr."""
    proc = subprocess.run([sys.executable, "-m", module] + [str(a) for a in args],
                          capture_output=True, text=True, timeout=timeout, cwd=ROOT)
    check(proc.returncode == 0,
          f"{module} exited {proc.returncode}: {proc.stderr[-3000:]}")
    return proc.stdout


def surfaces_path(slam, frames, poses, pairs, pair_poses):
    """(c) run_slam tum-rgbd on phase 4's 36 RGB-D frames written as a TUM
    directory (8-bit PNGs, 16-bit depth), (d) run_slam kitti-stereo on
    phase 6's 30 pairs in the KITTI layout, (e) eval_datasets --dry-run,
    each a subprocess on the card; the PNGs written with the standard
    library and read back through the native decoder, built first; (f) the
    HTTP viewer on phase 4's system, /state.json once. Returns fields."""
    import importlib.util
    import tempfile
    import urllib.request

    from orbslam2_tpu_torch.utils import datasets, evaluation, native_io
    from orbslam2_tpu_torch.utils.http_viewer import HttpViewer

    fields = {"PIL": importlib.util.find_spec("PIL") is not None,
              "matplotlib": importlib.util.find_spec("matplotlib") is not None}
    t0 = time.perf_counter()
    check(native_io.native_available(),
          f"the native decoder did not build: {native_io.build_error}")
    fields["native_build_s"] = time.perf_counter() - t0
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        # (c) TUM RGB-D
        t0 = time.perf_counter()
        tum = os.path.join(tmp, "tum")
        datasets.write_tum_rgbd(tum, frames, poses)
        img0 = native_io.load_image(os.path.join(tum, "rgb", os.listdir(
            os.path.join(tum, "rgb"))[0]))
        check(img0.shape == (H, W), f"decoded {img0.shape}")
        settings = os.path.join(tum, "settings.yaml")
        with open(settings, "w") as f:
            f.write(datasets.settings_yaml(FX, FX, W / 2, H / 2, W, H, 52.0, 1000, 8))
        traj, kf_traj = os.path.join(tmp, "tum_traj.txt"), os.path.join(tmp, "tum_kf.txt")
        out = run_cli("orbslam2_tpu_torch.examples.run_slam", "tum-rgbd", settings,
                      tum, "--traj-out", traj, "--kf-traj-out", kf_traj)
        check(f"frames: {len(frames)}" in out, f"run_slam tum-rgbd: {out[-500:]}")
        lines = open(traj).read().split("\n")[:-1]
        check(all(len(ln.split()) == 8 for ln in lines), "not a TUM trajectory")
        check(len(open(kf_traj).read().split("\n")) > 1, "no keyframe trajectory")
        t_est, xyz_est = evaluation.load_tum_trajectory(traj)
        t_gt, xyz_gt = evaluation.load_tum_groundtruth(os.path.join(tum, "groundtruth.txt"))
        ia, ib = evaluation.associate_trajectories(t_est, t_gt)
        ate = evaluation.ate_rmse(xyz_est[ia], xyz_gt[ib], with_scale=False)
        check(ate < SURFACE_ATE, f"run_slam tum-rgbd ATE {ate} >= {SURFACE_ATE}")
        fields["tum_rgbd"] = dict(frames=len(frames), tracked=len(lines),
                                  n_assoc=len(ia), ate_m=ate,
                                  float_render_bound_m=ATE_BOUND,
                                  median_ms=float(out.split("median tracking time:")[1]
                                                  .split("ms")[0]),
                                  s=time.perf_counter() - t0)
        # (d) KITTI stereo
        t0 = time.perf_counter()
        kitti = os.path.join(tmp, "kitti")
        datasets.write_kitti(kitti, pairs)
        traj = os.path.join(tmp, "kitti_traj.txt")
        out = run_cli("orbslam2_tpu_torch.examples.run_slam", "kitti-stereo",
                      os.path.join(ROOT, "examples", "settings", "KITTI00-02.yaml"),
                      kitti, "--traj-out", traj, "--kf-traj-out",
                      os.path.join(tmp, "kitti_kf.txt"))
        check(f"frames: {len(pairs)}" in out, f"run_slam kitti-stereo: {out[-500:]}")
        rows = np.loadtxt(traj, ndmin=2)
        check(rows.shape[0] >= 1 and rows.shape[1] == 12, "not a KITTI trajectory")
        kitti_ate = None
        if rows.shape[0] == len(pairs):
            gt = np.stack([np.linalg.inv(T)[:3, 3] for T in pair_poses])
            kitti_ate = evaluation.ate_rmse(rows[:, [3, 7, 11]], gt, with_scale=False)
        fields["kitti_stereo"] = dict(frames=len(pairs), tracked=int(rows.shape[0]),
                                      ate_m=kitti_ate, float_render_bound_m=STEREO_ATE,
                                      median_ms=float(out.split("median tracking time:")[1]
                                                      .split("ms")[0]),
                                      s=time.perf_counter() - t0)
        # (e) the evaluation harness's dry run
        t0 = time.perf_counter()
        report = os.path.join(tmp, "eval.json")
        run_cli("orbslam2_tpu_torch.examples.eval_datasets", "--dry-run", "--out", report)
        with open(report) as f:
            res = json.load(f)["results"][0]
        check(res["ok"] and res["ate_rmse"] < SURFACE_ATE
              and res["n_assoc"] >= DRY_RUN_ASSOC, f"dry run: {res}")
        fields["dry_run"] = dict(ok=res["ok"], ate_m=res["ate_rmse"],
                                 n_assoc=res["n_assoc"], frames=res["frames"],
                                 fps=res["fps"], s=time.perf_counter() - t0)
    # (f) the HTTP viewer on phase 4's system
    viewer = HttpViewer(slam, port=0, interval=0.0)
    try:
        st = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{viewer.port}/state.json", timeout=30).read())
    finally:
        viewer.stop()
    want = dict(n_keyframes=len(slam.map.valid_keyframes()),
                n_map_points=len(slam.map.valid_map_points()),
                n_frames=len(slam.tracker.trajectory))
    got = {k: st[k] for k in want}
    check(got == want, f"viewer state {got} against the map's {want}")
    fields["viewer"] = got
    print(f"surfaces: run_slam tum-rgbd {fields['tum_rgbd']['tracked']} of "
          f"{len(frames)} tracked, ATE {fields['tum_rgbd']['ate_m']:.5f} m (8-bit "
          f"PNGs; bound {SURFACE_ATE}, float renders {ATE_BOUND}); kitti-stereo "
          f"{fields['kitti_stereo']['tracked']} of {len(pairs)}, ATE "
          f"{fields['kitti_stereo']['ate_m']}; dry run ok, ATE "
          f"{res['ate_rmse']:.5f} m, {res['n_assoc']} associated; viewer {got}; "
          f"PIL {fields['PIL']}, matplotlib {fields['matplotlib']}")
    return fields


# phase 11, the landmark-sharded global BA: the shapes of ba_parity.SHAPES
# past the local window (F and F' solving), the shards of one card, and
# the longest a gloo rank may take (its rendezvous and collectives wait 60 s)
MESH_SHAPES = ((64, 4096, 10), (256, 32768, 10))
MESH_SHARDS = (2, 4)
RANK_S = 120.0
PATHS["mesh"] = ("ba_linearize", "ba_solve", "ba_solve_blocked", "ba_update_cost",
                 "ba_accept", "shard_reduce")


def lm_counts(iters):
    """(LM iterations, phases) of the BA schedule with one outlier round."""
    from orbslam2_tpu_torch.ops import ba

    rest = max(iters // 2, 1)
    return iters + rest, len(ba._split(iters)) + len(ba._split(rest))


def reprojection_medians(m, cam, kfs):
    """Each keyframe's median reprojection error (px, level 0) over its
    live map points."""
    out = []
    for kf in kfs:
        T = m.kf_pose[kf]
        feats = np.where(m.kf_mp[kf] >= 0)[0]
        mps = m.kf_mp[kf, feats]
        live = m.mp_valid[mps]
        feats, mps = feats[live], mps[live]
        pc = m.mp_pos[mps] @ T[:3, :3].T + T[:3, 3]
        z = np.maximum(pc[:, 2], 1e-6)
        u = cam.fx * pc[:, 0] / z + cam.cx
        v = cam.fy * pc[:, 1] / z + cam.cy
        out.append(float(np.median(np.hypot(u - m.kf_xy[kf, feats, 0],
                                            v - m.kf_xy[kf, feats, 1]))))
    return out


def gloo_ranks(prob, cam, iters, world=2):
    """``world`` smoke_worker processes, each a gloo rank holding CUDA
    tensors on this card, a file:// rendezvous under a temporary directory;
    each waits at most RANK_S seconds, then is killed. Returns each rank's
    saved result."""
    import tempfile

    from orbslam2_tpu_torch.parallel import smoke_worker

    payload = {f"cam_{f}": np.asarray(getattr(cam, f)) for f in cam._fields}
    payload.update({f"prob_{f}": t.cpu().numpy() for f, t in zip(prob._fields, prob)})
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(os.path.join(tmp, "prob.npz"), **payload)
        out = os.path.join(tmp, "out.npz")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "orbslam2_tpu_torch.parallel.smoke_worker",
             str(r), str(world), f"file://{tmp}/rendezvous",
             os.path.join(tmp, "prob.npz"), out, "--device", "cuda",
             "--backend", "gloo", "--iters", str(iters)],
            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(world)]
        errs = []
        try:
            for p in procs:
                _, err = p.communicate(timeout=RANK_S)
                errs.append((p.returncode, err))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for rc, err in errs:
            check(rc == 0, f"mesh: a gloo rank failed ({rc}):\n{err[-2000:]}")
        return [dict(np.load(smoke_worker.out_path(out, r))) for r in range(world)]


def mesh_path(dev, record, loop_args):
    """Phase 11, the landmark-sharded global BA on one card. The path, its
    counts set to 0 just before and read just after: (a) the mesh of 2 and
    4 shards of the card at both MESH_SHAPES (each solve's launches: E, G
    and H once a shard an LM iteration, F or F' once, shard_reduce twice
    and once a phase); (b) LoopCloser.global_bundle_adjustment(use_mesh=True)
    over 4 shards on the circuit's map as phase 7's GBA found it, written
    back, reprojection medians < 1 px; (c) a one-rank NCCL group through
    parallel/distributed.py's all-reduce. Then, outside the counts: each
    mesh against the plain sharded schedule and the one-shard kernel
    schedule within ba_parity.LIMITS, the 4-shard mesh's second call the
    same bits, shard_reduce bit-exact against its plain twin on the rows
    the K = 256 mesh summed (its row), two gloo ranks sharing the card
    against (a)'s 2-shard result, across the first cards where there are
    several, and ms per LM iteration for 1, 2 and 4 shards. Returns
    (counts, the "mesh" line's fields)."""
    from datetime import timedelta
    import tempfile

    import torch.distributed as tdist

    from orbslam2_tpu_torch import kernels
    from orbslam2_tpu_torch.kernels import shard_reduce
    from orbslam2_tpu_torch.loop_closing import LoopCloser
    from orbslam2_tpu_torch.map.keyframe_database import KeyFrameDatabase
    from orbslam2_tpu_torch.models.camera import Camera
    from orbslam2_tpu_torch.ops import ba
    from orbslam2_tpu_torch.parallel import distributed, sharded_ba
    from orbslam2_tpu_torch.utils import ba_parity, slices
    from orbslam2_tpu_torch.utils.convert import map_state_from_numpy
    from orbslam2_tpu_torch.utils.synthetic import ba_window

    t_phase = time.perf_counter()
    cam = Camera.create(FX, FX, W / 2, H / 2, bf=52.0, width=W, height=H)
    probs = {K: ba.BAProblem(*(torch.from_numpy(a).to(dev)
                               for a in ba_window(K, M, 8, seed=K)))
             for K, M, _ in MESH_SHAPES}
    meshes = {n: sharded_ba.make_landmark_mesh([dev] * n) for n in MESH_SHARDS}
    fields = dict(card=card_line(), shapes={}, note=(
        "ms per LM iteration of shards of ONE card: the overhead of sharding "
        "(more launches, the reduction), not scaling"))

    # ---- the path ------------------------------------------------------------
    kernels.reset_launches()
    rk, per_solve, rows = {}, {}, {}
    for K, M, iters in MESH_SHAPES:
        for n in MESH_SHARDS:
            shards = sharded_ba.shard_problem(meshes[n], probs[K])
            before = kernels.launch_counts()
            with Capture(shard_reduce, "shard_reduce",
                         lambda a, k: a[0].shape[1] > 1) as cap_s, \
                    Capture(shard_reduce, "shard_reduce",
                            lambda a, k: a[0].shape[1] == 1) as cap_c:
                rk[K, n] = sharded_ba.make_sharded_ba(meshes[n], iters=iters)(
                    cam, shards)
            after = kernels.launch_counts()
            per_solve[K, n] = {k: after[k] - before[k] for k in after
                               if after[k] != before[k]}
            rows[K, n] = (cap_s.args[0][0], cap_c.args[0][0])

    # (b) the loop closer's mesh path on the circuit's map before its GBA
    cfg = slices.config("circuit")
    c = cfg.camera
    ccam = Camera.create(c.fx, c.fy, c.cx, c.cy, bf=c.bf, width=c.width,
                         height=c.height)
    m = map_state_from_numpy(cfg, loop_args["map_before_gba"], device=dev)
    lc = LoopCloser(cfg, m, ccam, KeyFrameDatabase(m, device=dev))
    _, kfs, _, _, _ = lc._gba_gather(None, None, 8)
    med_before = reprojection_medians(m, ccam, kfs)
    with Capture(lc, "_gba_solve_mesh") as cap_gba:
        lc.global_bundle_adjustment(use_mesh=True, mesh=meshes[4])
    gba_prob = cap_gba.args[0][0]
    gba_res = cap_gba.result

    # (c) a one-rank NCCL group through the all-reduce
    with tempfile.TemporaryDirectory() as tmp:
        tdist.init_process_group("nccl", init_method=f"file://{tmp}/nccl",
                                 world_size=1, rank=0,
                                 timeout=timedelta(seconds=distributed.RENDEZVOUS_S))
        try:
            gmesh = distributed.global_landmark_mesh(dev)
            check(isinstance(gmesh, distributed.DistributedMesh),
                  "mesh: the NCCL group is not a DistributedMesh")
            K0, _, it0 = MESH_SHAPES[0]
            r_nccl = sharded_ba.make_sharded_ba(gmesh, iters=it0)(
                cam, distributed.shard_problem_global(gmesh, probs[K0]))
            torch.cuda.synchronize()
        finally:
            tdist.destroy_process_group()
    counts = kernels.launch_counts()

    # ---- (a) held against the plain sharded schedule and one shard -------------
    for K, M, iters in MESH_SHAPES:
        n_lm, n_phases = lm_counts(iters)
        r1 = ba.optimize_ba(cam, probs[K], iters=iters, outlier_rounds=1)
        shape = dict(n_lm=n_lm)
        for n in MESH_SHARDS:
            f_name = "ba_solve" if K <= 64 else "ba_solve_blocked"
            want = {"ba_linearize": n * n_lm, f_name: n_lm, "ba_accept": n * n_lm,
                    "ba_update_cost": n * (n_lm + n_phases + 2),
                    "shard_reduce": 2 * n_lm + n_phases}
            check(per_solve[K, n] == want,
                  f"mesh K={K} n={n}: launches {per_solve[K, n]}, want {want}")
            shards = sharded_ba.shard_problem(meshes[n], probs[K])
            rp = sharded_ba.make_sharded_ba(meshes[n], iters=iters, plain=True)(
                cam, shards)
            vs_plain = ba_parity.compare(cam, probs[K], rk[K, n], rp)
            vs_one = ba_parity.compare(cam, probs[K], rk[K, n], r1)
            check(not ba_parity.over_limits(vs_plain) and not ba_parity.over_limits(vs_one),
                  f"mesh K={K} n={n}: vs plain {vs_plain}, vs one shard {vs_one}")
            again = sharded_ba.make_sharded_ba(meshes[n], iters=iters)(cam, shards)
            same = all(torch.equal(a, b) for a, b in zip(rk[K, n], again))
            check(same, f"mesh K={K} n={n}: a second call gave other bits")
            for x in rows[K, n]:
                check(torch.equal(shard_reduce.shard_reduce(x),
                                  shard_reduce.shard_reduce_plain(x)),
                      f"kernel shard_reduce not bit-exact on {tuple(x.shape)}")
            L = rows[K, n][0].shape[1]
            shape[n] = dict(vs_plain=vs_plain, vs_one_shard=vs_one,
                            second_call_same_bits=same, launches=per_solve[K, n],
                            reduce_bytes_per_iteration=4 * (n + 1) * (L + 2))
            print(f"mesh K={K} M={M} n={n}: vs plain poses {vs_plain['poses']:.2e} "
                  f"points {vs_plain['points']:.2e} reproj {vs_plain['reproj']:.2e} "
                  f"px cost {vs_plain['cost']:.2e}; vs one shard poses "
                  f"{vs_one['poses']:.2e} points {vs_one['points']:.2e}; second "
                  f"call same bits {same}; launches {per_solve[K, n]}")
        # ms per LM iteration, each solve between CUDA events
        ms = {1: cuda_ms(lambda: ba.optimize_ba(cam, probs[K], iters=iters,
                                                outlier_rounds=1), reps=3, warmup=1)}
        for n in MESH_SHARDS:
            fn = sharded_ba.make_sharded_ba(meshes[n], iters=iters)
            shards = sharded_ba.shard_problem(meshes[n], probs[K])
            ms[n] = cuda_ms(lambda: fn(cam, shards), reps=3, warmup=1)
        shape["ms_per_lm_iteration"] = {n: v / n_lm for n, v in ms.items()}
        fields["shapes"][f"K={K} M={M} O=8"] = shape

    # ---- shard_reduce's row: the K = 256 4-shard mesh's summed rows ---------
    x = rows[MESH_SHAPES[-1][0], 4][0]
    n, L = x.shape
    err = (shard_reduce.shard_reduce(x) - shard_reduce.shard_reduce_plain(x)).abs().max()
    record(shard_reduce, err.item(), lambda: shard_reduce.shard_reduce(x),
           cuda_ms(lambda: shard_reduce.shard_reduce_plain(x)),
           f"bit-exact; n={n} shards, L={L} (S | b_S at K={MESH_SHAPES[-1][0]}); "
           f"library: torch.sum(x, dim=0)",
           library_ms=cuda_ms(lambda: torch.sum(x, dim=0)),
           # n rows read once, one row written; n - 1 additions an element
           n_bytes=4 * (n + 1) * L, n_ops=(n - 1) * L)

    # ---- (b) the loop closer: written back, sub-pixel -------------------------
    _, kfs, mp_ids, opt_mask, n_ids = lc._gba_gather(None, None, 8)
    med_after = reprojection_medians(lc.map, ccam, kfs)
    written = (np.array_equal(lc.map.kf_pose[np.asarray(kfs)[opt_mask]],
                              gba_res.poses.cpu().numpy()[opt_mask])
               and np.array_equal(lc.map.mp_pos[mp_ids],
                                  gba_res.points.cpu().numpy()[:n_ids]))
    check(written, "mesh: the loop closer's mesh GBA was not written back")
    check(gba_res.points.shape[0] % 4 == 0, "mesh: the GBA problem was not padded")
    check(max(med_after) < 1.0, f"mesh: reprojection medians {max(med_after)} px")
    fields["loop_closer"] = dict(
        K=int(gba_prob.poses.shape[0]), M=int(gba_prob.points.shape[0]),
        M_padded=int(gba_res.points.shape[0]), shards=4,
        median_px_before=max(med_before), median_px_after=max(med_after))

    # ---- (c) the NCCL group and two gloo ranks ---------------------------------
    K0, _, it0 = MESH_SHAPES[0]
    r1 = ba.optimize_ba(cam, probs[K0], iters=it0, outlier_rounds=1)
    vs_nccl = ba_parity.compare(cam, probs[K0], r_nccl, r1)
    check(not ba_parity.over_limits(vs_nccl), f"mesh: one-rank NCCL {vs_nccl}")
    t = time.perf_counter()
    ranks = gloo_ranks(probs[K0], cam, it0)
    rank_s = time.perf_counter() - t
    check(all(np.array_equal(r["poses"], ranks[0]["poses"]) for r in ranks),
          "mesh: the gloo ranks hold different poses")
    got = ba.BAResult(
        poses=torch.from_numpy(ranks[0]["poses"]).to(dev),
        points=torch.from_numpy(np.concatenate([r["points"] for r in ranks])).to(dev),
        obs_inlier=torch.from_numpy(np.concatenate([r["obs_inlier"] for r in ranks])).to(dev),
        cost=torch.tensor(float(ranks[0]["cost"]), device=dev))
    vs_gloo = ba_parity.compare(cam, probs[K0], got, rk[K0, 2])
    check(not ba_parity.over_limits(vs_gloo), f"mesh: gloo ranks vs the mesh {vs_gloo}")
    fields["nccl_one_rank_vs_one_shard"] = vs_nccl
    fields["nccl_same_bits_as_one_shard"] = all(
        torch.equal(a, b) for a, b in zip(r_nccl, r1))
    fields["gloo_2_ranks_vs_2_shards"] = vs_gloo
    fields["gloo_s"] = rank_s

    # ---- (d) across cards, where the machine has several -------------------------
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        cards = sharded_ba.make_landmark_mesh(
            [torch.device("cuda", i) for i in range(min(4, n_cards))])
        shards = sharded_ba.shard_problem(cards, probs[K0])
        rc = sharded_ba.make_sharded_ba(cards, iters=it0)(cam, shards)
        rp = sharded_ba.make_sharded_ba(cards, iters=it0, plain=True)(cam, shards)
        vs = ba_parity.compare(cam, probs[K0], rc, rp)
        check(not ba_parity.over_limits(vs), f"mesh across {cards.size} cards: {vs}")
        fields["across_cards"] = dict(cards=cards.size, vs_plain=vs)
    else:
        fields["across_cards"] = "1 card visible: not run"
    fields["phase_s"] = time.perf_counter() - t_phase
    return counts, fields


def main():
    t_start = time.perf_counter()
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
               per_call=1, bound_override=None, function="", reps=20,
               batched=False):
        """One kernel's row: ms is one call of ``fn`` between CUDA events
        (host work included; ``per_call`` launches, e.g. every pyramid
        level), device_ms the kernel's own device time per call, plain_ms
        the plain version's call between CUDA events, library_ms one
        PyTorch call of the same function where there is one. The bound is
        bound(n_bytes, n_ops), or ``bound_override`` (ms, by) where the work
        runs at another peak. ``function=None`` takes every device event
        of the call (a kernel that runs another's launches); ``reps`` calls
        are timed each way (fewer for a call of seconds). ``batched`` rows
        (phase 10's: the profiler recorded none of Y's launches at training
        shape in 4 of 5 runs) take device_ms from batch_ms over ``reps`` calls instead of the
        profiler, as does a row that no profile recorded (``device_ms``);
        the row's ``device_ms_by`` says which. Returns the row."""
        ms = cuda_ms(fn, reps=reps, warmup=min(3, reps))
        if batched:
            dev_ms = batch_ms(fn, reps)
            by = f"CUDA events around {reps} back-to-back calls"
        else:
            key = mod.FUNCTION if function == "" else function
            dev_ms = device_ms(fn, key, reps=reps, per_call=per_call)
            by = profile_fallbacks.pop(key, "torch.profiler")
        bound_ms, bound_by = bound_override or bound(n_bytes, n_ops)
        seen, launched = ((None, None) if batched else
                          profile_gaps.pop(mod.FUNCTION, (reps * per_call,) * 2))
        if by != "torch.profiler" and not batched:
            seen = 0
        rows.append(dict(name=mod.NAME, route="cuda", source=mod.SOURCE,
                         replaces=mod.REPLACES, max_abs_err=float(err),
                         ms=ms, device_ms=dev_ms, device_ms_by=by,
                         device_events=None if batched else f"{seen} of {launched}",
                         plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=library_ms))
        lib = "" if library_ms is None else f", library {library_ms:.4f} ms"
        part = ("" if seen == launched else
                f", from a profile that recorded {seen} of {launched} launches")
        if by != "torch.profiler":
            part = f", {by}"
        print(f"kernel {mod.NAME}: {note}; {ms:.4f} ms a call (device "
              f"{dev_ms:.4f} ms{part}) vs plain {plain_ms:.4f} ms{lib}, bound "
              f"{bound_ms:.6f} ms ({bound_by})")
        return rows[-1]

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
    pose_lm_nan_check(dev, d_args, valid)

    cascade_rows(dev, record, cam, local_map, feats, d_kp, T_pred)
    bnd = {r["name"]: r["bound_ms"] for r in rows}
    per_pass = sum(bnd[k] for k in ("project_gate", "hamming_top2_gated",
                                    "claim_resolve", "pose_lm"))
    print(f"cascade bound (a tracked frame): 3 x (O + C + Q + D) + R = "
          f"{3 * per_pass + bnd['cascade_pack']:.6f} ms")
    mapping_rows(dev, record, cam, extractor, frames, poses)
    ba_rows(dev, record)
    blocked_rows(dev, record)
    pose_graph_cg_launches(dev)
    front_rows(dev, record, img0, frames[0][1], feats, cam)
    print(f"device times: {len(rows)} kernels; profiles that missed launches "
          f"(kernel, events, launches, margin events kept before and after, "
          f"of {MARGIN} each): {profile_retries or 'none'}")

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
    print(f"rgbd: kernel Y launched {counts['bow_words']} times for "
          f"{int(slam.kfdb.in_db.sum())} keyframes in the database")
    path_counts = {"rgbd": counts}

    # ---- phase 5: relocalization and localization mode --------------------
    path_counts["reloc"], y_args, ur_args, z_args = reloc_path(dev, slam, frames, poses)

    # ---- phase 6: the stereo, fallback and monocular paths -----------------
    slam_s, path_counts["stereo"], pairs, pair_poses, v_args, w_args = stereo_path(dev)
    path_counts["fallback"], u_args, _ = fallback_path(dev, slam_s, pairs[-1])
    path_counts["mono"], uw_args, x_args = mono_path(dev)

    # ---- phase 7: loop closing on the circuit ------------------------------
    path_counts["loop"], loop_args, loop_fields = loop_path(dev)
    print("loop " + json.dumps(loop_fields))

    # ---- phase 8: loop closing at map scale ----------------------------------
    path_counts["scale"], scale_args, scale_fields = scale_path(dev)

    # ---- phase 9: the asynchronous system ------------------------------------
    path_counts["async"] = async_path(dev, record, frames, poses,
                                      len(times) / sum(times))

    # ---- phase 10: the offline and dataset surfaces ----------------------------
    path_counts["vocab"], vocab_args, vocab_fields = vocab_path(dev)
    vocab_fields.update(surfaces_path(slam, frames, poses, pairs, pair_poses))

    # ---- phase 11: the landmark-sharded global BA ------------------------------
    path_counts["mesh"], mesh_fields = mesh_path(dev, record, loop_args)
    print("mesh " + json.dumps(mesh_fields, default=str))
    for path, names in PATHS.items():
        for name in names:
            check(path_counts[path][name] > 0,
                  f"kernel {name} never launched on the {path} path")
    for path in ("loop", "scale", "async", "vocab", "mesh"):
        launched = {k for k, v in path_counts[path].items() if v > 0}
        check(launched == set(PATHS[path]),
              f"the {path} path launched {sorted(launched ^ set(PATHS[path]))} "
              f"against PATHS[{path!r}]")
    n_retries = len(profile_retries)
    port_rows(dev, record, u_args, uw_args, v_args, w_args, x_args)
    reloc_rows(dev, record, y_args, ur_args, z_args)
    loop_rows(dev, record, loop_args)
    vocab_rows(dev, record, vocab_args, vocab_fields)
    print("surfaces " + json.dumps(vocab_fields))
    t_rows = time.perf_counter()
    scale_rows(dev, record, scale_args, scale_fields)
    scale_fields["rows_s"] = time.perf_counter() - t_rows
    print("scale " + json.dumps(scale_fields))
    print(f"device times of U, V, W, X, Y, Z, K, M, P, P': profiles that missed "
          f"launches (kernel, events, launches, margin events kept before and "
          f"after, of {MARGIN} each): {profile_retries[n_retries:] or 'none'}")
    # Y's training launches go to its row at training shape
    total = {mod.NAME: sum(c[mod.NAME] for p, c in path_counts.items()
                           if p != "vocab" or mod.NAME != "bow_words")
             for mod in kernels.KERNELS}
    for name, n in total.items():
        check(n > 0, f"kernel {name} launched on no path")
    total[Y_TRAINING] = path_counts["vocab"]["bow_words"]
    check(sorted(r["name"] for r in rows) == sorted(total),
          "the kernels line does not hold every kernel once (and Y at "
          "training shape)")
    for row in rows:
        row["launches"] = total[row["name"]]

    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from the start, the "
          f"kernels' build included")
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
