"""Stereo rectification for EuRoC-style radial-tangential cameras (port of
``orbslam2_tpu.utils.rectify``, host numpy).

ORB-SLAM2's stereo_euroc example preloads LEFT.K/LEFT.D/LEFT.R/LEFT.P from
its EuRoC.yaml and calls cv::initUndistortRectifyMap + cv::remap per frame.
``EurocRectifier`` computes the rectifying rotations from the dataset's
published sensor extrinsics instead (Fusiello-style: new x-axis along the
baseline, y orthogonal to the mean optical axis); ``YamlRectifier`` takes
the settings file's LEFT./RIGHT. blocks as the example does. Both build the
inverse maps once; a frame's remap is one vectorized bilinear gather. No
OpenCV dependency.
"""

from __future__ import annotations

import os
import re
from typing import Tuple

import numpy as np


def _radtan_distort(x: np.ndarray, y: np.ndarray, D: np.ndarray):
    """Apply [k1 k2 p1 p2] to normalized coords."""
    k1, k2, p1, p2 = D[:4]
    r2 = x * x + y * y
    rad = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return xd, yd


def rectify_rotations(R: np.ndarray, T: np.ndarray):
    """New-frame rotations (R1, R2) for cam0/cam1 with x2 = R x1 + T.

    Rows of the returned matrices are the rectified axes expressed in each
    camera's frame; after rotation the baseline is pure x.
    """
    C2 = -R.T @ T  # cam1 center in cam0 coords
    v1 = C2 / np.linalg.norm(C2)
    z_avg = np.array([0.0, 0.0, 1.0]) + R.T @ np.array([0.0, 0.0, 1.0])
    v2 = np.cross(z_avg, v1)
    v2 = v2 / np.linalg.norm(v2)
    v3 = np.cross(v1, v2)
    Rn = np.stack([v1, v2, v3])  # cam0 -> rectified
    return Rn, Rn @ R.T


def build_rectify_map(
    K_old: np.ndarray, D: np.ndarray, R_new: np.ndarray,
    K_new: np.ndarray, width: int, height: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """(map_x, map_y) source pixel coords for every rectified pixel."""
    u, v = np.meshgrid(np.arange(width, dtype=np.float64),
                       np.arange(height, dtype=np.float64))
    x = (u - K_new[0, 2]) / K_new[0, 0]
    y = (v - K_new[1, 2]) / K_new[1, 1]
    rays = np.stack([x, y, np.ones_like(x)], axis=-1) @ R_new  # R_new^T ray
    xn = rays[..., 0] / rays[..., 2]
    yn = rays[..., 1] / rays[..., 2]
    xd, yd = _radtan_distort(xn, yn, D)
    map_x = K_old[0, 0] * xd + K_old[0, 2]
    map_y = K_old[1, 1] * yd + K_old[1, 2]
    return map_x.astype(np.float32), map_y.astype(np.float32)


def remap_bilinear(img: np.ndarray, map_x: np.ndarray, map_y: np.ndarray):
    """Vectorized bilinear sampling (out-of-range -> 0)."""
    h, w = img.shape
    x0 = np.floor(map_x).astype(np.int32)
    y0 = np.floor(map_y).astype(np.int32)
    fx = map_x - x0
    fy = map_y - y0
    ok = (x0 >= 0) & (y0 >= 0) & (x0 < w - 1) & (y0 < h - 1)
    x0c = np.clip(x0, 0, w - 2)
    y0c = np.clip(y0, 0, h - 2)
    p00 = img[y0c, x0c]
    p01 = img[y0c, x0c + 1]
    p10 = img[y0c + 1, x0c]
    p11 = img[y0c + 1, x0c + 1]
    out = (p00 * (1 - fx) * (1 - fy) + p01 * fx * (1 - fy)
           + p10 * (1 - fx) * fy + p11 * fx * fy)
    return np.where(ok, out, 0.0).astype(img.dtype)


def _parse_euroc_sensor_yaml(path: str):
    """Minimal parser for EuRoC mav0/cam*/sensor.yaml (no pyyaml needed)."""
    text = open(path).read()

    def grab_list(key):
        m = re.search(key + r":\s*(?:\n\s*(?:rows|cols|data)[^\n]*)*"
                      r"(?:data:)?\s*\[([^\]]*)\]", text)
        if m is None:
            m = re.search(key + r":\s*\[([^\]]*)\]", text)
        return np.array([float(x) for x in m.group(1).split(",")])

    intr = grab_list("intrinsics")
    dist = grab_list("distortion_coefficients")
    tbs = grab_list("T_BS").reshape(4, 4)
    K = np.array([[intr[0], 0, intr[2]], [0, intr[1], intr[3]], [0, 0, 1.0]])
    return K, dist, tbs


class EurocRectifier:
    """Per-sequence rectifier built from mav0/cam{0,1}/sensor.yaml."""

    def __init__(self, seq_root: str, K_new: np.ndarray,
                 width: int = 752, height: int = 480):
        K0, D0, T0 = _parse_euroc_sensor_yaml(
            os.path.join(seq_root, "mav0", "cam0", "sensor.yaml"))
        K1, D1, T1 = _parse_euroc_sensor_yaml(
            os.path.join(seq_root, "mav0", "cam1", "sensor.yaml"))
        T_10 = np.linalg.inv(T1) @ T0  # x_c1 = T_10 x_c0
        R, T = T_10[:3, :3], T_10[:3, 3]
        R0n, R1n = rectify_rotations(R, T)
        self.map0 = build_rectify_map(K0, D0, R0n, K_new, width, height)
        self.map1 = build_rectify_map(K1, D1, R1n, K_new, width, height)
        self.baseline = float(np.linalg.norm(T))

    def __call__(self, left: np.ndarray, right: np.ndarray):
        return (remap_bilinear(left, *self.map0),
                remap_bilinear(right, *self.map1))


class YamlRectifier:
    """Rectifier from the reference's LEFT./RIGHT. settings blocks.

    Drop-in equivalent of the reference example's
    cv::initUndistortRectifyMap(K, D, R, P[:3,:3], size) + cv::remap pair
    (Examples/Stereo/stereo_euroc.cc): `blocks` is the parsed
    {"left": {K, D, R, P, width, height}, "right": {...}} payload from
    `config.load_config` (`SlamConfig.stereo_rectify`).
    """

    def __init__(self, blocks: dict):
        maps = {}
        for side in ("left", "right"):
            b = blocks[side]
            K_new = np.asarray(b["P"])[:3, :3]
            # build_rectify_map expects R_new rows = rectified axes in the
            # raw camera frame; OpenCV's R maps raw -> rectified, same
            # convention (x_rect = R x_raw).
            maps[side] = build_rectify_map(
                np.asarray(b["K"]), np.asarray(b["D"]), np.asarray(b["R"]),
                K_new, int(b["width"]), int(b["height"]),
            )
        self.map0 = maps["left"]
        self.map1 = maps["right"]

    def __call__(self, left: np.ndarray, right: np.ndarray):
        return (remap_bilinear(left, *self.map0),
                remap_bilinear(right, *self.map1))
