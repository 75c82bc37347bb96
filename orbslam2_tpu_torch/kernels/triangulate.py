"""Kernel S wrapper: local mapping's triangulation against B neighbour
keyframes (matching, DLT, source choice, acceptance gates).

Replaces ``orbslam2_tpu/local_mapping.py``: ``_triangulate_one_neighbor``
(vmapped over the neighbours by ``_triangulate_neighbors_kernel`` /
``_triangulate_neighbors_mirror``). CUDA source: ``csrc/triangulate.cu``
(a match launch, a warp per current-keyframe keypoint with the mutual
check by 64-bit atomicMin per neighbour keypoint, then a geometry launch,
a thread per pair; the (B, N, N) matrices never stored). F21, the
projection matrices and K^-1 are small torch products made on the host for
both versions. The match indices are bit-exact against the plain version.
The plain version writes the geometry term by term in the kernel's order
(the DLT through ``ops/geometry.triangulate_dlt``), so X and ``good`` agree
bit for bit unless cos or atan2 round apart; ``chip_smoke.py`` reports
which, and holds X to 1e-4 m.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import build, scale
from ..ops import geometry as geo
from ..ops import matching

NAME = "triangulate"
FUNCTION = "triangulate"  # both its __global__ functions hold this name
SOURCE = "orbslam2_tpu_torch/kernels/csrc/triangulate.cu"
REPLACES = "orbslam2_tpu/local_mapping.py:25"
launches = 0
MAX_KEYPOINTS = 4096  # (x, y, threshold) per keypoint in 48 KB of shared memory
NN_RATIO = 0.6


def _products(K, T1, T2):
    """F21 (B, 3, 3), P1 (3, 4), P2 (B, 3, 4) and K^-1, made on the host
    and copied to K's device (on the card, torch.linalg.inv would load a
    solver library at its first call and synchronise at every call)."""
    Kh, T1h, T2h = K.cpu(), T1.cpu(), T2.cpu()
    out = (matching.fundamental_from_poses(Kh, Kh, T1h, T2h), Kh @ T1h[:3, :],
           Kh @ T2h[:, :3, :], torch.linalg.inv(Kh))
    return tuple(t.to(K.device) for t in out)


def triangulate_plain(desc1, xy1, oct1, avail1, depth1, ur1, T1,
                      desc2, xy2, oct2, avail2, depth2, ur2, T2, nb_ok,
                      K, baseline: float, bf: float, sf: float
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Current keyframe: (N, ...) arrays and T1 (4, 4); neighbours: (B, N,
    ...) arrays, T2 (B, 4, 4), nb_ok (B,). Returns (X (B, N, 3), good
    (B, N), idx (B, N)): SearchForTriangulation (epipolar gate, TH_LOW,
    ratio 0.6, mutual), DLT vs measured-depth unprojection arbitrated by
    parallax cosines, then cheirality, chi2 (with the u_right residual),
    parallax and scale-consistency gates. Everything is masked, never
    compacted."""
    B, N = xy2.shape[:2]
    dev = xy2.device
    F21, P1, P2, Kinv = _products(K, T1, T2)
    sig2 = scale.table(sf, "sig2", dev)
    pair = matching.epipolar_gate(xy1.expand(B, N, 2), xy2, F21, sig2[oct2.long()])
    res = matching.match_descriptors(
        desc1.expand(B, N, 32), desc2, avail1.expand(B, N), avail2,
        pair_mask=pair, max_dist=matching.TH_LOW, nn_ratio=NN_RATIO, mutual=True,
    )
    idx = res.idx.clamp_min(0).long()
    x1 = xy1.expand(B, N, 2)
    x2 = xy2.gather(1, idx[..., None].expand(B, N, 2))
    o2 = oct2.gather(1, idx)
    d2m = depth2.gather(1, idx)
    u_r2 = ur2.gather(1, idx)

    X_dlt = geo.triangulate_dlt(P1.expand(B, 3, 4), P2, x1, x2)  # (B, N, 3)

    # every product below is written term by term, in kernel S's order; a
    # pose T broadcasts as T1 (4, 4) or T2[:, None] (B, 1, 4, 4)
    T2b = T2[:, None]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    def dot(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    def norm(a):
        return torch.sqrt(dot(a, a))

    def centre(T):                                   # -R^T t
        return [-(T[..., 0, k] * T[..., 0, 3] + T[..., 1, k] * T[..., 1, 3]
                  + T[..., 2, k] * T[..., 2, 3]) for k in range(3)]

    def rot_t(T, v):                                 # R^T v
        return [v[0] * T[..., 0, k] + v[1] * T[..., 1, k] + v[2] * T[..., 2, k]
                for k in range(3)]

    def ray(T, x):                                   # R^T K^-1 (x, y, 1)
        h = [x[..., 0] * Kinv[k, 0] + x[..., 1] * Kinv[k, 1] + Kinv[k, 2]
             for k in range(3)]
        return rot_t(T, h)

    def unproject(T, x, d):
        pc = [(x[..., 0] - cx) / fx * d, (x[..., 1] - cy) / fy * d, d]
        return [a + c for a, c in zip(rot_t(T, pc), centre(T))]

    def to_cam(T, X):                                # R X + t
        return [T[..., k, 0] * X[0] + T[..., k, 1] * X[1] + T[..., k, 2] * X[2]
                + T[..., k, 3] for k in range(3)]

    # source arbitration (cosParallaxRays vs cosParallaxStereo)
    r1, r2 = ray(T1, x1), ray(T2b, x2)
    cos_rays = dot(r1, r2) / (norm(r1) * norm(r2)).clamp_min(1e-12)
    has1 = (depth1 > 0).expand(B, N)
    has2 = d2m > 0
    cosp1 = torch.where(has1, torch.cos(2 * torch.atan2(
        torch.full_like(depth1, baseline / 2), depth1)), 2.0).expand(B, N)
    cosp2 = torch.where(has2, torch.cos(2 * torch.atan2(
        torch.full_like(d2m, baseline / 2), d2m)), 2.0)
    cosp_stereo = torch.minimum(cosp1, cosp2)
    use_dlt = (cos_rays < cosp_stereo) & (cos_rays > 0) & (
        has1 | has2 | (cos_rays < 0.9998))

    pick1 = ~use_dlt & has1 & (cosp1 <= cosp2)
    pick2 = ~use_dlt & has2 & ~pick1
    u1 = unproject(T1, xy1, depth1)
    u2 = unproject(T2b, x2, d2m)
    nan = torch.full_like(cos_rays, float("nan"))
    X = [torch.where(pick2, u2[k], torch.where(pick1, u1[k].expand(B, N),
                                               torch.where(use_dlt, X_dlt[..., k], nan)))
         for k in range(3)]

    # acceptance gates (CreateNewMapPoints tail)
    finite = torch.isfinite(X[0]) & torch.isfinite(X[1]) & torch.isfinite(X[2])
    Xs = [torch.where(finite, a, torch.zeros_like(a)) for a in X]
    pc1, pc2 = to_cam(T1, Xs), to_cam(T2b, Xs)
    z_ok = (pc1[2] > 0.05) & (pc2[2] > 0.05)

    def reproj_ok(pc, x, octv, ur):
        z = pc[2].clamp_min(1e-9)
        u = fx * pc[0] / z + cx
        v = fy * pc[1] / z + cy
        s2 = sig2[octv.long()]
        eu, ev = u - x[..., 0], v - x[..., 1]
        e2 = eu * eu + ev * ev
        er = u - torch.full_like(z, bf) / z - ur
        return torch.where(ur >= 0, e2 + er * er <= 7.8 * s2, e2 <= 5.991 * s2)

    r_ok = reproj_ok(pc1, x1, oct1.expand(B, N), ur1.expand(B, N)) & \
        reproj_ok(pc2, x2, o2, u_r2)
    n1 = [a - c for a, c in zip(Xs, centre(T1))]
    n2 = [a - c for a, c in zip(Xs, centre(T2b))]
    d1, d2 = norm(n1), norm(n2)
    cos_par = dot(n1, n2) / (d1 * d2).clamp_min(1e-12)
    par_ok = (cos_par < 0.9998) | ~use_dlt
    ratio_dist = d2 / d1.clamp_min(1e-9)
    ratio_oct = scale.table(sf, "signed", dev)[
        (o2 - oct1 + (scale.MAX_LEVELS - 1)).long()]
    sc_ok = (ratio_dist < ratio_oct * sf * 1.5) & (
        ratio_dist > ratio_oct / (torch.full_like(ratio_oct, sf) * 1.5))

    good = res.valid & nb_ok[:, None] & finite & z_ok & r_ok & par_ok & sc_ok
    Xs = torch.stack(Xs, -1)
    return torch.where(good[..., None], Xs, torch.zeros_like(Xs)), good, res.idx


def triangulate(desc1, xy1, oct1, avail1, depth1, ur1, T1,
                desc2, xy2, oct2, avail2, depth2, ur2, T2, nb_ok,
                K, baseline: float, bf: float, sf: float
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel S on CUDA tensors, the plain version on CPU tensors."""
    if xy2.device.type == "cpu":
        return triangulate_plain(desc1, xy1, oct1, avail1, depth1, ur1, T1,
                                 desc2, xy2, oct2, avail2, depth2, ur2, T2,
                                 nb_ok, K, baseline, bf, sf)
    dev = xy2.device
    B, N = xy2.shape[:2]
    if N > MAX_KEYPOINTS:
        raise ValueError(f"{NAME}: N={N} keypoints, the kernel takes N <= "
                         f"{MAX_KEYPOINTS}")
    f32, i32, u8, b8 = torch.float32, torch.int32, torch.uint8, torch.bool
    build.expect(NAME, dev, (
        ("desc1", desc1, u8, (N, 32)), ("xy1", xy1, f32, (N, 2)),
        ("oct1", oct1, i32, (N,)), ("avail1", avail1, b8, (N,)),
        ("depth1", depth1, f32, (N,)), ("ur1", ur1, f32, (N,)),
        ("T1", T1, f32, (4, 4)),
        ("desc2", desc2, u8, (B, N, 32)), ("xy2", xy2, f32, (B, N, 2)),
        ("oct2", oct2, i32, (B, N)), ("avail2", avail2, b8, (B, N)),
        ("depth2", depth2, f32, (B, N)), ("ur2", ur2, f32, (B, N)),
        ("T2", T2, f32, (B, 4, 4)), ("nb_ok", nb_ok, b8, (B,)),
        ("K", K, f32, (3, 3))))
    F21, P1, P2, Kinv = (t.contiguous() for t in _products(K, T1, T2))
    X = torch.empty((B, N, 3), dtype=f32, device=dev)
    good = torch.empty((B, N), dtype=b8, device=dev)
    idx = torch.empty((B, N), dtype=i32, device=dev)
    rows = torch.empty((3, B, N), dtype=i32, device=dev)
    col_key = torch.empty((B, N), dtype=torch.int64, device=dev)
    err = build.library().osl_triangulate(
        desc1.data_ptr(), xy1.data_ptr(), oct1.data_ptr(), avail1.data_ptr(),
        depth1.data_ptr(), ur1.data_ptr(), T1.data_ptr(), desc2.data_ptr(),
        xy2.data_ptr(), oct2.data_ptr(), avail2.data_ptr(), depth2.data_ptr(),
        ur2.data_ptr(), T2.data_ptr(), nb_ok.data_ptr(), B, N, F21.data_ptr(),
        P1.data_ptr(), P2.data_ptr(), Kinv.data_ptr(), K.data_ptr(),
        float(baseline), float(bf), float(sf), scale.MAX_LEVELS,
        scale.table(sf, "sig2", dev).data_ptr(),
        scale.table(sf, "signed", dev).data_ptr(), matching.TH_LOW, NN_RATIO,
        rows[0].data_ptr(), rows[1].data_ptr(), rows[2].data_ptr(),
        col_key.data_ptr(), X.data_ptr(), good.data_ptr(), idx.data_ptr(),
        build.stream_handle(dev))
    build.check(err, NAME)
    build.count_launch(__name__)
    return X, good, idx
