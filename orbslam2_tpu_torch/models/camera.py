"""Pinhole camera model with radial-tangential distortion (port of
``orbslam2_tpu.models.camera``).

The camera is a NamedTuple of Python floats, each rounded to float32 so that
``cam.fx * x`` on a float32 tensor computes exactly what the reference's
float32 scalar does. All functions broadcast over leading point dimensions.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def _f32(v) -> float:
    return float(np.float32(v))


class Camera(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    k1: float
    k2: float
    p1: float
    p2: float
    k3: float
    bf: float
    width: int
    height: int

    @staticmethod
    def create(fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0, bf=0.0,
               width=640, height=480) -> "Camera":
        return Camera(_f32(fx), _f32(fy), _f32(cx), _f32(cy), _f32(k1),
                      _f32(k2), _f32(p1), _f32(p2), _f32(k3), _f32(bf),
                      int(width), int(height))

    @property
    def K(self) -> np.ndarray:
        return np.array([[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy],
                         [0.0, 0.0, 1.0]], np.float32)

    @property
    def has_distortion(self) -> bool:
        return any(abs(v) > 0 for v in (self.k1, self.k2, self.p1, self.p2,
                                         self.k3))


def distort_normalized(cam: Camera, xn: torch.Tensor) -> torch.Tensor:
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + cam.k1 * r2 + cam.k2 * r2 * r2 + cam.k3 * r2 * r2 * r2
    xd = x * radial + 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_points(cam: Camera, uv: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Undistort pixel coords (..., 2) by fixed-point iteration
    (cv::undistortPoints analog, fixed iteration count)."""
    xn = torch.stack(
        [(uv[..., 0] - cam.cx) / cam.fx, (uv[..., 1] - cam.cy) / cam.fy], dim=-1
    )
    xd = xn
    xu = xn
    for _ in range(iters):
        xu = xd - (distort_normalized(cam, xu) - xu)
    return torch.stack(
        [xu[..., 0] * cam.fx + cam.cx, xu[..., 1] * cam.fy + cam.cy], dim=-1
    )


def project(cam: Camera, pc: torch.Tensor) -> torch.Tensor:
    """Camera-frame points (..., 3) -> pixels (..., 2), no distortion."""
    z = pc[..., 2]
    inv_z = 1.0 / torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)
    u = cam.fx * pc[..., 0] * inv_z + cam.cx
    v = cam.fy * pc[..., 1] * inv_z + cam.cy
    return torch.stack([u, v], dim=-1)


def in_image(cam: Camera, uv: torch.Tensor, border: float = 0.0) -> torch.Tensor:
    return (
        (uv[..., 0] >= border)
        & (uv[..., 0] < cam.width - border)
        & (uv[..., 1] >= border)
        & (uv[..., 1] < cam.height - border)
    )
