"""Sim3 refinement and guided Sim3 match growing (port of
``orbslam2_tpu.ops.sim3_opt``, plain PyTorch; kernel M,
``kernels/sim3_opt.py``, runs both on the card).

- ``optimize_sim3``: Levenberg-Marquardt on the loop transform S12 over
  paired reprojection edges. Each matched point gives a forward edge (the
  loop-side point through S12 into image 1) and an inverse edge (the
  current-side point through S12^-1 into image 2); Huber(sqrt(10)), 5
  iterations, the chi2 > 10 outliers of either edge removed, 10 more. The
  Jacobian of the 4N residuals at the left tangent xi = 0 comes from
  forward-mode autodiff (``torch.func.jacfwd``), as the reference's
  ``jax.jacfwd``.
- ``search_by_sim3``: both-direction guided projection matching under S12
  (radius 7.5 sf^pred, octave window [pred - 1, pred + 1], TH_HIGH, no
  ratio), kept where the two directions agree.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import geometry as geo
from . import matching
from ..kernels import scale
from ..models.camera import Camera, in_image, project

TH2 = 10.0          # chi2 gate on both edges
ITERS1, ITERS2 = 5, 10
RADIUS_MULT = 7.5


class Sim3OptResult(NamedTuple):
    S12: torch.Tensor        # (8,) refined sim3 (frame-2 coords -> frame-1)
    inliers: torch.Tensor    # (N,) bool
    n_inliers: torch.Tensor  # () int32


def residuals(cam: Camera, S12, p1c, p2c, u1, u2, inv_s1, inv_s2):
    """Stacked scaled residuals (N, 4): [forward uv, inverse uv]. S12 is
    taken as (1, 8): under torch.func's forward mode a 0-d scale's tangent
    comes out in float64."""
    S12 = S12.reshape(1, 8)
    pred1 = project(cam, geo.sim3_apply(S12, p2c))
    r1 = (u1 - pred1) * inv_s1[:, None]
    pred2 = project(cam, geo.sim3_apply(geo.sim3_inverse(S12), p1c))
    r2 = (u2 - pred2) * inv_s2[:, None]
    return torch.cat([r1, r2], dim=1)


def optimize_sim3(cam: Camera, S12_0, p1c, p2c, u1, u2, sigma2_1, sigma2_2,
                  valid, fix_scale: bool = False, th2: float = TH2,
                  iters1: int = ITERS1, iters2: int = ITERS2,
                  mid_inliers=None, decide=None) -> Sim3OptResult:
    """For a check against another LM, whose sums run in another order:
    ``mid_inliers``, given, replaces the chi2 gate's inlier set between the
    two phases, and ``decide``, given, a function (iteration, trial cost,
    current cost) -> bool, takes the place of the accept test trial <
    current (iterations counted over both phases)."""
    inv_s1 = 1.0 / torch.sqrt(sigma2_1.clamp_min(1e-9))
    inv_s2 = 1.0 / torch.sqrt(sigma2_2.clamp_min(1e-9))
    delta = th2 ** 0.5
    args = (p1c, p2c, u1, u2, inv_s1, inv_s2)
    eye7 = torch.eye(7, dtype=p1c.dtype, device=p1c.device)

    def edge_chi2(S):
        r = residuals(cam, S, *args)
        return (r[:, :2] ** 2).sum(1), (r[:, 2:] ** 2).sum(1)

    def hub(c):
        e = torch.sqrt(c + 1e-12)
        return torch.where(e <= delta, c, 2.0 * delta * e - delta * delta)

    def cost(S, mask):
        c1, c2 = edge_chi2(S)
        return (mask * (hub(c1) + hub(c2))).sum()

    def lm_phase(S, mask, n_iters, first):
        lam = torch.tensor(1e-3, dtype=p1c.dtype, device=p1c.device)
        maskf = mask.to(p1c.dtype)
        for it in range(n_iters):
            def res_flat(xi):
                # batched (1, 7), as in residuals
                Sx = geo.sim3_compose(geo.sim3_exp(xi[None]), S[None])[0]
                return residuals(cam, Sx, *args).reshape(-1)

            xi0 = torch.zeros(7, dtype=p1c.dtype, device=p1c.device)
            r = res_flat(xi0)                                    # (4N,)
            J = torch.func.jacfwd(res_flat)(xi0)                 # (4N, 7)
            rr = r.reshape(-1, 4)
            e1 = torch.sqrt((rr[:, :2] ** 2).sum(1) + 1e-12)
            e2 = torch.sqrt((rr[:, 2:] ** 2).sum(1) + 1e-12)
            w1 = torch.clamp(delta / e1, max=1.0)
            w2 = torch.clamp(delta / e2, max=1.0)
            w = torch.stack([w1, w1, w2, w2], 1).reshape(-1)
            w = w * maskf.repeat_interleave(4)
            H = (J * w[:, None]).T @ J
            g = J.T @ (w * r)
            if fix_scale:
                H = H.clone()
                H[6, :] = 0.0
                H[:, 6] = 0.0
                H[6, 6] = 1.0
                g = g.clone()
                g[6] = 0.0
            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * eye7
            dx = -torch.linalg.solve(Hd, g)
            S_new = geo.sim3_compose(geo.sim3_exp(dx), S)
            c_new, c_cur = cost(S_new, maskf), cost(S, maskf)
            better = c_new < c_cur
            if decide is not None:
                better = torch.tensor(bool(decide(first + it, c_new, c_cur)),
                                      device=p1c.device)
            S = torch.where(better, S_new, S)
            lam = torch.where(better, lam * 0.5, lam * 4.0).clamp(1e-6, 1e4)
        return S

    S = lm_phase(S12_0, valid, iters1, 0)
    c1, c2 = edge_chi2(S)
    inl = valid & (c1 <= th2) & (c2 <= th2)
    if mid_inliers is not None:
        inl = mid_inliers
    S = lm_phase(S, inl, iters2, iters1)
    c1, c2 = edge_chi2(S)
    inl = valid & (c1 <= th2) & (c2 <= th2)
    return Sim3OptResult(S12=S, inliers=inl, n_inliers=inl.to(torch.int32).sum())


def search_parts(S12):
    """((s, R, t) of S21 = S12^-1, (s, R, t) of S12): the transforms of the
    two directions, from the (8,) S12 as kernel M derives them on the
    device with csrc/sim3.cuh (the inverse's translation term by term, its
    rotation through its quaternion, as geometry.sim3_inverse)."""
    s, R, t = geo.sim3_s(S12), geo.sim3_R(S12), geo.sim3_t(S12)
    s_inv = 1.0 / s.clamp_min(geo._EPS)
    Rt = R.T
    t_inv = torch.stack([-s_inv * (Rt[i, 0] * t[0] + Rt[i, 1] * t[1] + Rt[i, 2] * t[2])
                         for i in range(3)])
    S21 = geo.sim3_make(s_inv, Rt, t_inv)
    return (geo.sim3_s(S21), geo.sim3_R(S21), geo.sim3_t(S21)), (s, R, t)


def direction_pairs(cam: Camera, parts, pos_src, dmax_src, kp_xy_dst,
                    kp_oct_dst, scale_factor: float, n_levels: int,
                    radius_mult: float = RADIUS_MULT):
    """(rows (N_src,), pair (N_src, N_dst)): the source's points through the
    Sim3 ``parts`` (s, R, t) that land in front (z > 0.1) and in the
    destination image, and the keypoints inside each one's radius
    radius_mult * sf^pred and octave window [pred - 1, pred + 1], the level
    predicted as ceil(log(max(dmax / max(dist, 1e-9), 1e-6)) / log(sf))
    clipped to [0, n_levels - 1]. Written term by term, in kernel M's
    order."""
    s, R, t = parts
    X, Y, Z = pos_src[:, 0], pos_src[:, 1], pos_src[:, 2]
    pc = [s * (R[i, 0] * X + R[i, 1] * Y + R[i, 2] * Z) + t[i] for i in range(3)]
    proj = project(cam, torch.stack(pc, 1))
    dist = torch.sqrt(pc[0] * pc[0] + pc[1] * pc[1] + pc[2] * pc[2])
    rows = (pc[2] > 0.1) & in_image(cam, proj)
    ratio = (dmax_src / dist.clamp_min(1e-9)).clamp_min(1e-6)
    # clipped before the conversion, so an infinite band gives the top level
    pred = torch.ceil(torch.log(ratio) / scale.log_sf(scale_factor)).clamp(
        0, n_levels - 1).to(torch.int32)
    r_px = scale.table(scale_factor, "pow", pos_src.device,
                       radius_mult)[pred.long()]
    pair = matching.radius_gate(proj, kp_xy_dst, r_px) & \
        matching.octave_gate(pred, kp_oct_dst, lo=-1, hi=1)
    return rows, pair


def one_direction(cam: Camera, parts, pos_src, dmax_src, desc_src, valid_src,
                  kp_xy_dst, kp_oct_dst, desc_dst, valid_dst,
                  scale_factor: float, n_levels: int,
                  radius_mult: float = RADIUS_MULT) -> matching.MatchResult:
    """The source's points matched to the destination's keypoints inside
    ``direction_pairs``: the smallest Hamming distance, TH_HIGH, no
    ratio."""
    rows, pair = direction_pairs(cam, parts, pos_src, dmax_src, kp_xy_dst,
                                 kp_oct_dst, scale_factor, n_levels, radius_mult)
    return matching.match_descriptors(desc_src, desc_dst, valid_src & rows,
                                      valid_dst, pair_mask=pair,
                                      max_dist=matching.TH_HIGH, nn_ratio=1.0)


def search_by_sim3(cam: Camera, S12, pos1_c, desc1, valid1, dmax1, kp_xy1,
                   kp_oct1, pos2_c, desc2, valid2, dmax2, kp_xy2, kp_oct2,
                   scale_factor: float, n_levels: int,
                   radius_mult: float = RADIUS_MULT):
    """(idx2 (N1,) int32, mutual (N1,) bool): the feature of image 2 each
    feature of image 1 matches where both directions agree, else -1."""
    parts21, parts12 = search_parts(S12)
    res12 = one_direction(cam, parts21, pos1_c, dmax1, desc1, valid1, kp_xy2,
                          kp_oct2, desc2, valid2, scale_factor, n_levels,
                          radius_mult)
    res21 = one_direction(cam, parts12, pos2_c, dmax2, desc2, valid2, kp_xy1,
                          kp_oct1, desc1, valid1, scale_factor, n_levels,
                          radius_mult)
    i1 = torch.arange(pos1_c.shape[0], dtype=torch.int32, device=pos1_c.device)
    j = torch.where(res12.valid, res12.idx, torch.zeros_like(res12.idx)).long()
    mutual = res12.valid & (res21.idx[j] == i1) & res21.valid[j]
    return torch.where(mutual, res12.idx, torch.full_like(res12.idx, -1)), mutual
