"""Kernel O wrapper: projection, frustum test and PredictScale of the local
map for one pass of the tracking cascade.

Replaces the front half of ``orbslam2_tpu/tracking.py``:
``_project_match_opt`` (R X + t, ``project``, isInFrustum, PredictScale,
the search radius r sf^level and the predicted u_right). CUDA source:
``csrc/project_gate.cu`` (one thread per point; every output bit-exact
against the plain version but for log() of the scale ratio, whose
``pred_level`` chip_smoke.py counts).

The plain version writes each product out term by term, in the kernel's
order: a matrix product or a norm would let the card's libraries contract
or reorder the sums.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import build, scale

NAME = "project_gate"
FUNCTION = "project_gate_kernel"  # the __global__ function it launches
SOURCE = "orbslam2_tpu_torch/kernels/csrc/project_gate.cu"
REPLACES = "orbslam2_tpu/tracking.py:97"
launches = 0


class Projection(NamedTuple):
    proj: torch.Tensor        # (P, 2) pixels
    r_px: torch.Tensor        # (P,) search radius
    pred_level: torch.Tensor  # (P,) int32 predicted octave
    ur_pred: torch.Tensor     # (P,) predicted u_right
    row_valid: torch.Tensor   # (P,) bool: valid and in the frustum


def _empty(P, dev) -> Projection:
    f = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)  # noqa: E731
    return Projection(f(P, 2), f(P), torch.empty(P, dtype=torch.int32, device=dev),
                      f(P), torch.empty(P, dtype=torch.bool, device=dev))


def project_gate_plain(cam, Tcw, mp_pos, mp_valid, mp_normal, mp_dmin, mp_dmax,
                       radius: float, scale_factor: float, n_levels: int,
                       gate=None) -> Projection:
    if not build.gate_open(gate):
        return _empty(mp_pos.shape[0], mp_pos.device)
    X, Y, Z = mp_pos[:, 0], mp_pos[:, 1], mp_pos[:, 2]
    pc = [Tcw[i, 0] * X + Tcw[i, 1] * Y + Tcw[i, 2] * Z + Tcw[i, 3]
          for i in range(3)]
    z = pc[2]
    inv_z = 1.0 / torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)
    u = cam.fx * pc[0] * inv_z + cam.cx
    v = cam.fy * pc[1] * inv_z + cam.cy
    in_img = (u >= 0.0) & (u < cam.width) & (v >= 0.0) & (v < cam.height)

    t = Tcw[:3, 3]
    vec = [mp_pos[:, j] - (-(Tcw[0, j] * t[0] + Tcw[1, j] * t[1] + Tcw[2, j] * t[2]))
           for j in range(3)]
    dist = torch.sqrt(vec[0] * vec[0] + vec[1] * vec[1] + vec[2] * vec[2])
    nv = vec[0] * mp_normal[:, 0] + vec[1] * mp_normal[:, 1] + vec[2] * mp_normal[:, 2]
    cos_view = nv / dist.clamp_min(1e-9)
    frustum = ((z > 0.1) & in_img & (dist >= 0.8 * mp_dmin)
               & (dist <= 1.2 * mp_dmax) & (cos_view > 0.5))

    # PredictScale; log(sf) and sf^level from the host (kernels/scale.py),
    # and a tensor divisor (on the card a scalar one becomes a reciprocal)
    ratio = (mp_dmax / dist.clamp_min(1e-9)).clamp_min(1e-6)
    lvl = torch.ceil(torch.log(ratio) / torch.full_like(ratio, scale.log_sf(scale_factor)))
    lvl = lvl.to(torch.int32).clamp(0, n_levels - 1)
    r_px = radius * scale.table(scale_factor, "pow", mp_pos.device)[lvl.long()]
    ur_pred = u - torch.full_like(z, cam.bf) / z.clamp_min(1e-6)
    return Projection(torch.stack([u, v], 1), r_px, lvl, ur_pred, mp_valid & frustum)


def project_gate(cam, Tcw, mp_pos, mp_valid, mp_normal, mp_dmin, mp_dmax,
                 radius: float, scale_factor: float, n_levels: int,
                 gate=None) -> Projection:
    """Kernel O on CUDA tensors, the plain version on CPU tensors. With a
    ``gate`` (count, threshold) the pass runs only while the device count
    is below the threshold; otherwise the outputs are left unwritten."""
    if mp_pos.device.type == "cpu":
        return project_gate_plain(cam, Tcw, mp_pos, mp_valid, mp_normal, mp_dmin,
                                  mp_dmax, radius, scale_factor, n_levels, gate)
    dev = mp_pos.device
    P = mp_pos.shape[0]
    if not 1 <= n_levels <= scale.MAX_LEVELS:
        raise ValueError(f"{NAME}: n_levels must be in [1, {scale.MAX_LEVELS}]")
    build.expect(NAME, dev, (
        ("Tcw", Tcw, torch.float32, (4, 4)),
        ("mp_pos", mp_pos, torch.float32, (P, 3)),
        ("mp_valid", mp_valid, torch.bool, (P,)),
        ("mp_normal", mp_normal, torch.float32, (P, 3)),
        ("mp_dmin", mp_dmin, torch.float32, (P,)),
        ("mp_dmax", mp_dmax, torch.float32, (P,))))
    out = _empty(P, dev)
    gate_n, gate_min = build.gate_args(gate)
    err = build.library().osl_project_gate(
        Tcw.data_ptr(), mp_pos.data_ptr(), mp_valid.data_ptr(),
        mp_normal.data_ptr(), mp_dmin.data_ptr(), mp_dmax.data_ptr(), P,
        cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, cam.width, cam.height,
        float(radius), scale.log_sf(scale_factor),
        scale.table(scale_factor, "pow", dev).data_ptr(), n_levels,
        gate_n, gate_min, *(t.data_ptr() for t in out),
        build.stream_handle(dev))
    build.check(err, NAME)
    build.count_launch(__name__)
    return out
