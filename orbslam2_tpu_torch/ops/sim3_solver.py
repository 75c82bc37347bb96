"""Batched Sim3 RANSAC: closed-form Horn on 3-point sets and the both-way
reprojection inlier count (port of ``orbslam2_tpu.ops.sim3_solver``, plain
PyTorch; kernel K, ``kernels/sim3_ransac.py``, runs it on the card).

Given matched map points expressed in the camera frames of two keyframes,
each hypothesis is a 3-correspondence Horn alignment (with scale for
monocular, fixed scale for stereo / RGB-D); inliers are the pairs whose
reprojections agree within th2 * sigma^2 in both images. The best
hypothesis is refit by Horn on its inliers and kept if the refit counts at
least as many.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import geometry as geo
from ..models.camera import Camera

TH2 = 9.21  # the reprojection chi2 gate (2 DoF, 99%)


class Sim3Result(NamedTuple):
    S12: torch.Tensor      # (8,) sim3 vector mapping frame-2 coords -> frame-1
    inliers: torch.Tensor  # (N,) bool
    n_inliers: torch.Tensor
    ok: torch.Tensor


def reproj_chi2(cam: Camera, pc, ref, s2):
    """Squared pixel distance between the projections of ``pc`` and
    ``ref`` (..., N, 3), over s2; depths floored at 1e-6."""
    z = pc[..., 2].clamp_min(1e-6)
    u = cam.fx * pc[..., 0] / z + cam.cx
    v = cam.fy * pc[..., 1] / z + cam.cy
    zr = ref[..., 2].clamp_min(1e-6)
    ur = cam.fx * ref[..., 0] / zr + cam.cx
    vr = cam.fy * ref[..., 1] / zr + cam.cy
    return ((u - ur) ** 2 + (v - vr) ** 2) / s2


def count_inliers(cam: Camera, S12, pts1_c, pts2_c, sigma2_1, sigma2_2, valid,
                  th2: float = TH2):
    """(inliers (..., N), counts (...,)) of Sim3 vectors S12 (..., 8)."""
    p2_in_1 = geo.sim3_apply(S12[..., None, :], pts2_c)
    p1_in_2 = geo.sim3_apply(geo.sim3_inverse(S12)[..., None, :], pts1_c)
    e1 = reproj_chi2(cam, p2_in_1, pts1_c, sigma2_1)
    e2 = reproj_chi2(cam, p1_in_2, pts2_c, sigma2_2)
    inl = valid & (e1 < th2) & (e2 < th2)
    return inl, inl.to(torch.int32).sum(-1)


def sim3_ransac(cam: Camera, pts1_c, pts2_c, sigma2_1, sigma2_2, valid, samples,
                fix_scale: bool = False, min_inliers: int = 20,
                th2: float = TH2) -> Sim3Result:
    """``samples`` (I, 3) int32 index triples into the (N, 3) points."""
    idx = samples.long()
    s, R, t = geo.horn_align(pts2_c[idx], pts1_c[idx], with_scale=not fix_scale)
    hyps = geo.sim3_make(s, R, t)                                  # (I, 8)
    inls, counts = count_inliers(cam, hyps, pts1_c, pts2_c, sigma2_1,
                                 sigma2_2, valid, th2)
    finite = torch.isfinite(hyps).all(1) & (geo.sim3_s(hyps) > 1e-4)
    counts = torch.where(finite, counts, torch.full_like(counts, -1))
    best = counts.argmax()
    w = inls[best].to(pts1_c.dtype)
    s, R, t = geo.horn_align(pts2_c, pts1_c, weights=w, with_scale=not fix_scale)
    S_ref = geo.sim3_make(s, R, t)
    inl_ref, n_ref = count_inliers(cam, S_ref, pts1_c, pts2_c, sigma2_1,
                                   sigma2_2, valid, th2)
    use_ref = n_ref >= counts[best]
    S_out = torch.where(use_ref, S_ref, hyps[best])
    inl_out = torch.where(use_ref, inl_ref, inls[best])
    n_out = torch.where(use_ref, n_ref, counts[best])
    return Sim3Result(S12=S_out, inliers=inl_out, n_inliers=n_out,
                      ok=n_out >= min_inliers)
