"""Dataset-readiness harness: the BASELINE.md benchmark matrix in one run.

Finds which TUM / KITTI / EuRoC sequences exist under a data root, runs each
with its ORB-SLAM2 settings file (the repository's examples/settings/),
computes ATE RMSE / RPE (``utils/evaluation.py``, the TUM evaluate_ate.py
and KITTI devkit analogs), compares them with the BASELINE.md bounds and
writes EVAL_RESULTS.json:

  python -m orbslam2_tpu_torch.examples.eval_datasets --data-root /data
  python -m orbslam2_tpu_torch.examples.eval_datasets --only tum-fr1-desk
  python -m orbslam2_tpu_torch.examples.eval_datasets --dry-run

``--dry-run`` renders a synthetic TUM-format directory (30 frames, 320x240)
and runs the whole path on it: dataset IO, SlamSystem, ground-truth
association, Horn-aligned ATE against the 0.10 m bound, the report. The
system runs on the card unless ``--device cpu``.

Layouts searched per sequence (first hit wins):
  TUM:   <root>/rgbd_dataset_freiburg1_desk  (+ any extra parent dir level)
  KITTI: <root>/sequences/00 + <root>/poses/00.txt (or dataset/ in between)
  EuRoC: <root>/MH_01_easy/mav0 (or V1_01_easy etc.)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from ..config import load_config
from ..device import DEFAULT as DEFAULT_DEVICE
from ..system import SlamSystem
from ..utils import datasets, evaluation
from .run_slam import run_frames

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SETTINGS = os.path.join(REPO, "examples", "settings")

# BASELINE.md accuracy table (reference published ATE RMSE), with the
# acceptance bound = 2x the published number (CI slack; the goal is parity,
# the bound catches regressions/divergence).
SEQUENCES = [
    # name, kind, settings, dataset dir name, published ATE (m)
    ("tum-fr1-desk",  "tum-rgbd", "TUM1.yaml", "rgbd_dataset_freiburg1_desk",  0.016),
    ("tum-fr1-desk2", "tum-rgbd", "TUM1.yaml", "rgbd_dataset_freiburg1_desk2", 0.022),
    ("tum-fr1-room",  "tum-rgbd", "TUM1.yaml", "rgbd_dataset_freiburg1_room",  0.047),
    ("tum-fr1-xyz",   "tum-rgbd", "TUM1.yaml", "rgbd_dataset_freiburg1_xyz",   0.010),
    ("tum-fr2-desk",  "tum-rgbd", "TUM2.yaml", "rgbd_dataset_freiburg2_desk",  0.009),
    ("tum-fr2-xyz",   "tum-rgbd", "TUM2.yaml", "rgbd_dataset_freiburg2_xyz",   0.004),
    ("tum-fr3-office", "tum-rgbd", "TUM3.yaml",
     "rgbd_dataset_freiburg3_long_office_household", 0.010),
    ("tum-fr1-xyz-mono", "tum-mono", "TUM1.yaml", "rgbd_dataset_freiburg1_xyz", 0.009),
    ("tum-fr2-xyz-mono", "tum-mono", "TUM2.yaml", "rgbd_dataset_freiburg2_xyz", 0.003),
] + [
    (f"kitti-{s:02d}", "kitti-stereo",
     "KITTI00-02.yaml" if s <= 2 else ("KITTI03.yaml" if s == 3 else "KITTI04-12.yaml"),
     f"{s:02d}", bound)
    for s, bound in enumerate([1.3, 10.4, 5.7, 0.6, 0.2, 0.8, 0.8, 0.5, 3.6, 3.2, 1.0])
] + [
    (f"euroc-{n.lower().replace('_easy', '').replace('_medium', '').replace('_difficult', '')}",
     "euroc-stereo", "EuRoC.yaml", n, bound)
    for n, bound in [
        ("MH_01_easy", 0.035), ("MH_02_easy", 0.018), ("MH_03_medium", 0.028),
        ("MH_04_difficult", 0.119), ("MH_05_difficult", 0.060),
        ("V1_01_easy", 0.035), ("V1_02_medium", 0.020), ("V2_01_easy", 0.025),
        ("V2_02_medium", 0.048),
    ]
]

BOUND_SLACK = 2.0


def _find_tum(root: str, dirname: str):
    for base in (root, os.path.join(root, "tum")):
        p = os.path.join(base, dirname)
        if os.path.isfile(os.path.join(p, "rgb.txt")):
            return p
    return None


def _find_kitti(root: str, seq: str):
    for base in (root, os.path.join(root, "kitti"),
                 os.path.join(root, "kitti", "dataset"),
                 os.path.join(root, "dataset")):
        p = os.path.join(base, "sequences", seq)
        if os.path.isfile(os.path.join(p, "times.txt")):
            gt = os.path.join(base, "poses", f"{seq}.txt")
            return p, (gt if os.path.isfile(gt) else None)
    return None, None


def _find_euroc(root: str, name: str):
    for base in (root, os.path.join(root, "euroc")):
        p = os.path.join(base, name)
        if os.path.isdir(os.path.join(p, "mav0", "cam0", "data")):
            return p
    return None


def run_sequence(kind: str, settings_path: str, seq_dir: str,
                 max_frames: int = 0, device=DEFAULT_DEVICE):
    """Run one sequence through the full SlamSystem; returns (slam, fps, n).
    EuRoC stereo frames are rectified from the sequence's own sensor.yaml
    files."""
    sensor = {"tum-rgbd": "rgbd", "tum-mono": "monocular",
              "kitti-stereo": "stereo", "kitti-mono": "monocular",
              "euroc-stereo": "stereo"}[kind]
    cfg = load_config(settings_path, sensor=sensor)
    slam = SlamSystem(cfg, device=device)
    rectifier = None
    if kind == "euroc-stereo":
        from ..utils.rectify import EurocRectifier
        K_new = np.array([[cfg.camera.fx, 0, cfg.camera.cx],
                          [0, cfg.camera.fy, cfg.camera.cy], [0, 0, 1.0]])
        rectifier = EurocRectifier(seq_dir, K_new, cfg.camera.width,
                                   cfg.camera.height)
    times = []
    t0 = time.perf_counter()
    run_frames(kind, seq_dir, cfg, slam, times, max_frames, rectifier)
    wall = time.perf_counter() - t0
    slam.shutdown()
    return slam, (len(times) / wall if wall > 0 else 0.0), len(times)


def evaluate(slam: SlamSystem, kind: str, seq_dir: str,
             kitti_gt: str | None = None, gt_path: str | None = None):
    """ATE RMSE (+RPE when pose gt exists) for a finished run."""
    traj = slam.trajectory()
    if not traj:
        return dict(ate_rmse=float("inf"), n_tracked=0)
    est_ts = np.array([ts for _, ts, _ in traj])
    est_xyz = np.stack([np.linalg.inv(T)[:3, 3] for _, _, T in traj])
    with_scale = kind.endswith("mono")

    if kind.startswith("tum"):
        gt_file = gt_path or os.path.join(seq_dir, "groundtruth.txt")
        gt_ts, gt_xyz = evaluation.load_tum_groundtruth(gt_file)
        ia, ib = evaluation.associate_trajectories(est_ts, gt_ts)
        ate = evaluation.ate_rmse(est_xyz[ia], gt_xyz[ib], with_scale)
        return dict(ate_rmse=ate, n_tracked=len(traj), n_assoc=len(ia))
    if kind.startswith("kitti"):
        if kitti_gt is None:
            return dict(ate_rmse=None, n_tracked=len(traj),
                        note="poses/*.txt not found")
        gt = evaluation.load_kitti_poses(kitti_gt)
        fids = np.array([fid for fid, _, _ in traj])
        keep = fids < len(gt)
        est = est_xyz[keep]
        gtp = gt[fids[keep]][:, :3, 3]
        ate = evaluation.ate_rmse(est, gtp, with_scale)
        # KITTI-devkit-style relative translation over ~100-frame windows
        est_T = np.stack([np.linalg.inv(T) for _, _, T in traj])[keep]
        rpe_t, rpe_r = evaluation.rpe(est_T, gt[fids[keep]], delta=100) \
            if keep.sum() > 110 else (None, None)
        return dict(ate_rmse=ate, n_tracked=len(traj), rpe_t_100=rpe_t)
    # euroc
    gt_file = gt_path or os.path.join(
        seq_dir, "mav0", "state_groundtruth_estimate0", "data.csv")
    if not os.path.isfile(gt_file):
        return dict(ate_rmse=None, n_tracked=len(traj), note="gt csv missing")
    gt_ts, gt_xyz = evaluation.load_euroc_groundtruth(gt_file)
    ia, ib = evaluation.associate_trajectories(est_ts, gt_ts, max_dt=0.01)
    ate = evaluation.ate_rmse(est_xyz[ia], gt_xyz[ib], with_scale)
    return dict(ate_rmse=ate, n_tracked=len(traj), n_assoc=len(ia))


def dry_run(out_json: str, n_frames: int = 30, device=DEFAULT_DEVICE):
    """Self-contained validation on a rendered synthetic TUM-format dir:
    proves the whole harness path (dataset IO -> SlamSystem -> ATE vs
    groundtruth -> report) without real assets. The PNGs are written with
    the standard library (``native_io.write_png``)."""
    import tempfile
    from ..utils.synthetic import render_sequence

    K = np.array([[260.0, 0, 160], [0, 260, 120], [0, 0, 1]], np.float32)
    with tempfile.TemporaryDirectory() as td:
        d = os.path.join(td, "seq")
        frames, poses = render_sequence(n_frames, K, width=320, height=240,
                                        with_depth=True)
        datasets.write_tum_rgbd(d, frames, poses)
        with open(os.path.join(d, "settings.yaml"), "w") as f:
            f.write(datasets.settings_yaml(260.0, 260.0, 160.0, 120.0, 320, 240,
                                           26.0, 500, 4))
        slam, fps, n = run_sequence(
            "tum-rgbd", os.path.join(d, "settings.yaml"), d, device=device)
        res = evaluate(slam, "tum-rgbd", d)
        res.update(name="dry-run-synthetic", fps=round(fps, 2), frames=n,
                   bound_m=0.10, ok=bool(res["ate_rmse"] < 0.10))
        report = {"results": [res], "dry_run": True}
        with open(out_json, "w") as f:
            json.dump(report, f, indent=2)
        print(json.dumps(res))
        return 0 if res["ok"] else 1


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-root", default=os.environ.get("SLAM_DATA_DIR", "/data"))
    ap.add_argument("--only", default="",
                    help="comma-separated sequence names (default: all found)")
    ap.add_argument("--family", default="",
                    help="restrict to tum / kitti / euroc")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--out", default="EVAL_RESULTS.json")
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="torch device (default: the card; 'cpu' to run "
                         "on the CPU)")
    args = ap.parse_args(argv)

    if args.dry_run:
        sys.exit(dry_run(args.out, device=args.device))

    only = set(args.only.split(",")) if args.only else None
    results, missing = [], []
    for name, kind, settings, dirname, published in SEQUENCES:
        if only and name not in only:
            continue
        if args.family and not name.startswith(args.family):
            continue
        kitti_gt = None
        if kind.startswith("tum"):
            seq_dir = _find_tum(args.data_root, dirname)
        elif kind.startswith("kitti"):
            seq_dir, kitti_gt = _find_kitti(args.data_root, dirname)
        else:
            seq_dir = _find_euroc(args.data_root, dirname)
        if seq_dir is None:
            missing.append(name)
            continue
        print(f"=== {name}: {seq_dir}")
        slam, fps, n = run_sequence(kind, os.path.join(SETTINGS, settings),
                                    seq_dir, args.max_frames, args.device)
        res = evaluate(slam, kind, seq_dir, kitti_gt=kitti_gt)
        bound = published * BOUND_SLACK
        ok = res["ate_rmse"] is not None and res["ate_rmse"] <= bound
        res.update(name=name, frames=n, fps=round(fps, 2),
                   published_m=published, bound_m=bound, ok=bool(ok))
        results.append(res)
        print(json.dumps(res))

    report = dict(results=results, missing=missing,
                  data_root=args.data_root)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(f"\n{len(results)} sequences run, {len(missing)} not found "
          f"(missing: {', '.join(missing[:8])}{'...' if len(missing) > 8 else ''})")
    if results:
        n_ok = sum(r["ok"] for r in results)
        print(f"within 2x published bound: {n_ok}/{len(results)}")
        sys.exit(0 if n_ok == len(results) else 1)


if __name__ == "__main__":
    main()
