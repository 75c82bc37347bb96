"""The JAX package's stereo SlamSystem on the KITTI-width rendered pairs,
frame by frame: what the keyframe decision reads.

    JAX_PLATFORMS=cpu python tools/reference_slice_keyframes.py [--frames 30]
        [--step 1]

Settings ``examples/settings/KITTI00-02.yaml`` (1241x376, bf 386.1448,
2000 features, 8 levels); the box room's orbit, drawn for 30 frames/s, of
which every ``--step``-th pose is taken (3 is the settings' 10 frames/s);
the right camera shifted by bf / fx along +x. Loop closing is off. Each
frame prints the pose's inliers against the points the reference keyframe
tracks (the ratio ThRefRatio reads) and the close-point census; then the
keyframes and the ATE. The port prints the same lines with
``python -m orbslam2_tpu_torch.utils.slices --sensor stereo --step N``.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from orbslam2_tpu.config import load_config  # noqa: E402
from orbslam2_tpu.system import SlamSystem  # noqa: E402
from orbslam2_tpu.utils.evaluation import ate_rmse  # noqa: E402
from orbslam2_tpu.utils.synthetic import make_box_room, orbit_trajectory, render  # noqa: E402

SETTINGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples", "settings", "KITTI00-02.yaml")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--step", type=int, default=1)
    args = ap.parse_args()
    cfg = load_config(SETTINGS, sensor="stereo")
    c = cfg.camera
    K = np.array([[c.fx, 0.0, c.cx], [0.0, c.fy, c.cy], [0.0, 0.0, 1.0]], np.float32)
    planes = make_box_room(seed=0)
    poses = orbit_trajectory(args.step * args.frames)[::args.step]
    Trl = np.eye(4, dtype=np.float32)
    Trl[0, 3] = -c.bf / c.fx   # right cam: x_r = x_l - b
    slam = SlamSystem(cfg, enable_loop_closing=False)
    tr, m = slam.tracker, slam.map
    est, gt = [], []
    for i, Tcw_true in enumerate(poses):
        left = render(planes, K, Tcw_true, c.width, c.height)
        right = render(planes, K, Trl @ Tcw_true, c.width, c.height)
        pose = slam.track_stereo(left, right, i / c.fps)
        ref = int((m.kf_mp[tr.ref_kf] >= 0).sum()) if tr.ref_kf >= 0 else 0
        print(f"frame {i}: tracked {int(pose is not None)}, inliers "
              f"{tr.n_inliers_last}, reference keyframe tracks {ref}, share "
              f"{tr.n_inliers_last / max(ref, 1):.3f}, close tracked "
              f"{tr.n_tracked_close} untracked {tr.n_untracked_close}, keyframes "
              f"{len(m.valid_keyframes())}", flush=True)
        if pose is not None:
            est.append(np.linalg.inv(pose)[:3, 3])
            gt.append(np.linalg.inv(Tcw_true)[:3, 3])
    kfs = m.valid_keyframes()
    print(f"reference stereo {c.width}x{c.height}, step {args.step}, "
          f"{len(poses)} frames: {len(est)} tracked, {len(kfs)} keyframes "
          f"(frames {m.kf_frame_id[kfs].tolist()}), "
          f"ATE {ate_rmse(np.array(est), np.array(gt), with_scale=False):.5f} m")


if __name__ == "__main__":
    main()
