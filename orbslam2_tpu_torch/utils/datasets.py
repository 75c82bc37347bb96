"""Dataset loaders: TUM RGB-D, KITTI odometry, EuRoC MAV (port of
``orbslam2_tpu.utils.datasets``).

The ORB-SLAM2 examples' LoadImages functions and associate.py: the same
directory layouts and file formats, returned as python iterators of
(timestamp, grayscale float32 arrays). Images decode through
``native_io.load_image`` (the native PNG decoder, built at first use; PIL
where it cannot be built): grey 8- and 16-bit PNGs give the reference's
arrays exactly; an RGB PNG's grey is the native decoder's float luma, within
half a grey level of PIL's rounded one.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from .native_io import load_image


def _load_gray(path: str) -> np.ndarray:
    return load_image(path)


def _load_depth_png(path: str, factor: float) -> np.ndarray:
    return load_image(path) / factor


# ---------------------------------------------------------------------------
# TUM RGB-D (rgbd_tum.cc / mono_tum.cc + associate.py)
# ---------------------------------------------------------------------------

def _read_tum_list(path: str) -> List[Tuple[float, str]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out.append((float(parts[0]), parts[1]))
    return out


def associate(
    a: List[Tuple[float, str]], b: List[Tuple[float, str]], max_dt: float = 0.02
) -> List[Tuple[float, str, str]]:
    """Greedy timestamp association (Examples/RGB-D/associate.py)."""
    out = []
    j = 0
    for ta, pa in a:
        while j + 1 < len(b) and abs(b[j + 1][0] - ta) < abs(b[j][0] - ta):
            j += 1
        if j < len(b) and abs(b[j][0] - ta) <= max_dt:
            out.append((ta, pa, b[j][1]))
    return out


def tum_rgbd_sequence(
    root: str, depth_factor: float = 5000.0
) -> Iterator[Tuple[float, np.ndarray, np.ndarray]]:
    """Yields (timestamp, gray, depth_m) from a TUM fr*/ directory."""
    rgb = _read_tum_list(os.path.join(root, "rgb.txt"))
    depth = _read_tum_list(os.path.join(root, "depth.txt"))
    for ts, prgb, pdepth in associate(rgb, depth):
        yield ts, _load_gray(os.path.join(root, prgb)), _load_depth_png(
            os.path.join(root, pdepth), depth_factor
        )


def tum_mono_sequence(root: str) -> Iterator[Tuple[float, np.ndarray]]:
    for ts, p in _read_tum_list(os.path.join(root, "rgb.txt")):
        yield ts, _load_gray(os.path.join(root, p))


# ---------------------------------------------------------------------------
# KITTI odometry (mono_kitti.cc / stereo_kitti.cc)
# ---------------------------------------------------------------------------

def kitti_sequence(
    root: str, stereo: bool = False
) -> Iterator[Tuple[float, np.ndarray, Optional[np.ndarray]]]:
    """Yields (timestamp, left, right?) from a KITTI sequence dir
    (image_0/ image_1/ times.txt)."""
    with open(os.path.join(root, "times.txt")) as f:
        times = [float(x) for x in f.read().split()]
    left_dir = os.path.join(root, "image_0")
    right_dir = os.path.join(root, "image_1")
    for i, ts in enumerate(times):
        name = f"{i:06d}.png"
        left = _load_gray(os.path.join(left_dir, name))
        right = _load_gray(os.path.join(right_dir, name)) if stereo else None
        yield ts, left, right


# ---------------------------------------------------------------------------
# EuRoC MAV (mono_euroc.cc / stereo_euroc.cc)
# ---------------------------------------------------------------------------

def euroc_sequence(
    root: str, stereo: bool = False
) -> Iterator[Tuple[float, np.ndarray, Optional[np.ndarray]]]:
    """Yields (timestamp_s, cam0, cam1?) from mav0/ layout."""
    cam0 = os.path.join(root, "mav0", "cam0", "data")
    cam1 = os.path.join(root, "mav0", "cam1", "data")
    names = sorted(os.listdir(cam0))
    for name in names:
        if not name.endswith(".png"):
            continue
        ts = float(name[:-4]) * 1e-9
        left = _load_gray(os.path.join(cam0, name))
        right = (
            _load_gray(os.path.join(cam1, name))
            if stereo and os.path.exists(os.path.join(cam1, name))
            else None
        )
        yield ts, left, right


# ---------------------------------------------------------------------------
# Writers: rendered sequences in the datasets' layouts (for the runners'
# tests, the evaluation harness's dry run and the card's smoke test)
# ---------------------------------------------------------------------------

def write_tum_rgbd(root: str, frames, poses, t0: float = 1000.0,
                   fps: float = 30.0, depth_factor: float = 5000.0) -> List[float]:
    """A TUM RGB-D directory from rendered ``frames`` [(grey, depth_m)] and
    their ``poses`` (Tcw): rgb/*.png (8-bit), depth/*.png (16-bit, metres x
    ``depth_factor``), rgb.txt, depth.txt and groundtruth.txt (camera
    centres, identity quaternions). Returns the timestamps."""
    from .native_io import write_png

    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    rgb_lines, depth_lines, gt_lines, stamps = [], [], [], []
    for i, (img, depth) in enumerate(frames):
        ts = t0 + i / fps
        rp, dp = f"rgb/{ts:.6f}.png", f"depth/{ts:.6f}.png"
        write_png(os.path.join(root, rp), np.asarray(img).astype(np.uint8))
        write_png(os.path.join(root, dp),
                  (np.asarray(depth) * depth_factor).astype(np.uint16))
        rgb_lines.append(f"{ts:.6f} {rp}")
        depth_lines.append(f"{ts:.6f} {dp}")
        t = np.linalg.inv(poses[i])[:3, 3]
        gt_lines.append(f"{ts:.6f} {t[0]} {t[1]} {t[2]} 0 0 0 1")
        stamps.append(ts)
    for name, lines in (("rgb.txt", rgb_lines), ("depth.txt", depth_lines),
                        ("groundtruth.txt", gt_lines)):
        with open(os.path.join(root, name), "w") as f:
            f.write("# timestamp data\n" + "\n".join(lines) + "\n")
    return stamps


def write_kitti(root: str, pairs, fps: float = 10.0) -> List[float]:
    """A KITTI odometry sequence directory from rendered stereo ``pairs``
    [(left, right)]: image_0/, image_1/ (8-bit PNGs) and times.txt."""
    from .native_io import write_png

    for sub in ("image_0", "image_1"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    times = [i / fps for i in range(len(pairs))]
    for i, (left, right) in enumerate(pairs):
        for sub, img in (("image_0", left), ("image_1", right)):
            write_png(os.path.join(root, sub, f"{i:06d}.png"),
                      np.clip(np.round(np.asarray(img)), 0, 255).astype(np.uint8))
    with open(os.path.join(root, "times.txt"), "w") as f:
        f.write("\n".join(f"{t:.6e}" for t in times) + "\n")
    return times


def settings_yaml(fx: float, fy: float, cx: float, cy: float, width: int,
                  height: int, bf: float, n_features: int, n_levels: int,
                  fps: float = 30.0, depth_factor: float = 5000.0) -> str:
    """An ORB-SLAM2 settings file (OpenCV FileStorage YAML) for a pinhole
    camera without distortion."""
    return ("%YAML:1.0\n"
            f"Camera.fx: {fx}\nCamera.fy: {fy}\nCamera.cx: {cx}\nCamera.cy: {cy}\n"
            "Camera.k1: 0.0\nCamera.k2: 0.0\nCamera.p1: 0.0\nCamera.p2: 0.0\n"
            f"Camera.width: {width}\nCamera.height: {height}\nCamera.fps: {fps}\n"
            f"Camera.bf: {bf}\nCamera.RGB: 1\nThDepth: 35.0\n"
            f"DepthMapFactor: {depth_factor}\n"
            f"ORBextractor.nFeatures: {n_features}\nORBextractor.scaleFactor: 1.2\n"
            f"ORBextractor.nLevels: {n_levels}\nORBextractor.iniThFAST: 20\n"
            "ORBextractor.minThFAST: 7\n")
