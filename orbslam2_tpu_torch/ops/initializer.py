"""Monocular map initialization: batched H/F RANSAC + model selection (port
of ``orbslam2_tpu.ops.initializer``, plain PyTorch).

The function-for-function plain version of kernel X
(``kernels/two_view.py``), which runs the same stages on the card in four
launches: all 200 H and 200 F hypotheses from their minimal sets, scored by
symmetric transfer error (``hypotheses``); the winners' weighted all-inlier
refits, the model choice RH = SH / (SH + SF) > 0.40 and the decomposition
into 8 (H, Faugeras) or 4 (E) candidate poses (``refine``); ``check_rt``
for each candidate (``check_hypotheses``); the acceptance gates
(``select``). Same thresholds as the reference: sigma 1, chi2 5.991 (H),
3.841 + 5.991 (F), at least 50 triangulated points, parallax above 1 degree.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import geometry as geo

SIGMA = 1.0
TH_H = 5.991
TH_F = 3.841
TH_SCORE = 5.991
N_ITERS = 200
MIN_TRIANGULATED = 50
MIN_PARALLAX_DEG = 1.0


# ---------------------------------------------------------------------------
# Normalization (Initializer::Normalize)
# ---------------------------------------------------------------------------

def normalize_points(x: torch.Tensor, valid: torch.Tensor):
    """Zero-mean unit-mean-abs-dev normalization. Returns (xn, T) with
    xn = T x (homogeneous)."""
    w = valid.to(x.dtype)
    n = w.sum().clamp_min(1.0)
    mean = (x * w[:, None]).sum(0) / n
    d = (x - mean).abs() * w[:, None]
    md = (d.sum(0) / n).clamp_min(1e-8)
    s = 1.0 / md
    xn = (x - mean) * s
    zero, one = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = torch.stack([torch.stack([s[0], zero, -mean[0] * s[0]]),
                     torch.stack([zero, s[1], -mean[1] * s[1]]),
                     torch.stack([zero, zero, one])])
    return xn, T


# ---------------------------------------------------------------------------
# Minimal-set model fits (batched over hypotheses)
# ---------------------------------------------------------------------------

def _smallest_eigvec(A: torch.Tensor) -> torch.Tensor:
    """The eigenvector of the smallest eigenvalue of A^T A, (..., 9) float64:
    the normal matrix and its eigen-solve in float64, as kernel X computes
    them (the float32 eigh of the reference is accurate to ~1e-4 here)."""
    A = A.double()
    _, V = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    return V[..., :, 0]


def _h_dlt64(p1, p2, w=None) -> torch.Tensor:
    u1, v1 = p1[..., 0], p1[..., 1]
    u2, v2 = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(u1)
    o = torch.ones_like(u1)
    r1 = torch.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], -1)
    r2 = torch.stack([u1, v1, o, z, z, z, -u2 * u1, -u2 * v1, -u2], -1)
    if w is not None:
        r1 = r1 * w[..., None]
        r2 = r2 * w[..., None]
    h = _smallest_eigvec(torch.cat([r1, r2], -2))             # (..., 2M, 9)
    return h.reshape(h.shape[:-1] + (3, 3))


def _f_8point64(p1, p2, w=None) -> torch.Tensor:
    u1, v1 = p1[..., 0], p1[..., 1]
    u2, v2 = p2[..., 0], p2[..., 1]
    o = torch.ones_like(u1)
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, o], -1)
    if w is not None:
        A = A * w[..., None]
    f = _smallest_eigvec(A)
    F = f.reshape(f.shape[:-1] + (3, 3))
    U, S, Vt = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], -1)
    return U @ (S[..., None] * Vt)


def _solve_h_dlt(p1, p2, w=None) -> torch.Tensor:
    """H21 from >= 4 correspondences (2 DLT rows each): p2 ~ H p1.
    (..., M, 2); ``w`` (..., M) weights the all-inlier refit."""
    return _h_dlt64(p1, p2, w).to(p1.dtype)


def _solve_f_8point(p1, p2, w=None) -> torch.Tensor:
    """F21 from >= 8 correspondences: x2^T F21 x1 = 0, rank 2 enforced.
    (..., M, 2); ``w`` (..., M) weights the all-inlier refit."""
    return _f_8point64(p1, p2, w).to(p1.dtype)


def _denormalize(M64, L, T1) -> torch.Tensor:
    """L @ M @ T1 in float64, rounded to float32 (kernel X's order)."""
    return (L.double() @ M64 @ T1.double()).float()


# ---------------------------------------------------------------------------
# Symmetric transfer scoring (CheckHomography / CheckFundamental)
# ---------------------------------------------------------------------------

def score_homography(H21, x1, x2, valid, sigma=SIGMA):
    H12 = torch.linalg.inv(H21.double()).to(H21.dtype)
    inv_s2 = 1.0 / (sigma * sigma)

    def transfer(H, a, b):
        w = H[..., 2, 0] * a[..., 0] + H[..., 2, 1] * a[..., 1] + H[..., 2, 2]
        iw = 1.0 / torch.where(w.abs() < 1e-8, torch.full_like(w, 1e-8), w)
        u = (H[..., 0, 0] * a[..., 0] + H[..., 0, 1] * a[..., 1] + H[..., 0, 2]) * iw
        v = (H[..., 1, 0] * a[..., 0] + H[..., 1, 1] * a[..., 1] + H[..., 1, 2]) * iw
        return ((u - b[..., 0]) ** 2 + (v - b[..., 1]) ** 2) * inv_s2

    chi2_21 = transfer(H21[..., None, :, :], x1, x2)
    chi2_12 = transfer(H12[..., None, :, :], x2, x1)
    in1 = (chi2_21 < TH_H) & valid
    in2 = (chi2_12 < TH_H) & valid
    zero = torch.zeros_like(chi2_21)
    score = torch.where(in1, TH_H - chi2_21, zero).sum(-1) + torch.where(
        in2, TH_H - chi2_12, zero).sum(-1)
    return score, in1 & in2


def score_fundamental(F21, x1, x2, valid, sigma=SIGMA):
    inv_s2 = 1.0 / (sigma * sigma)

    def line_chi2(F, a, b):
        l0 = F[..., 0, 0] * a[..., 0] + F[..., 0, 1] * a[..., 1] + F[..., 0, 2]
        l1 = F[..., 1, 0] * a[..., 0] + F[..., 1, 1] * a[..., 1] + F[..., 1, 2]
        l2 = F[..., 2, 0] * a[..., 0] + F[..., 2, 1] * a[..., 1] + F[..., 2, 2]
        num = l0 * b[..., 0] + l1 * b[..., 1] + l2
        return (num * num) / (l0 * l0 + l1 * l1).clamp_min(1e-12) * inv_s2

    chi2_2 = line_chi2(F21[..., None, :, :], x1, x2)
    chi2_1 = line_chi2(F21.transpose(-1, -2)[..., None, :, :], x2, x1)
    in2 = (chi2_2 < TH_F) & valid
    in1 = (chi2_1 < TH_F) & valid
    zero = torch.zeros_like(chi2_2)
    score = torch.where(in2, TH_SCORE - chi2_2, zero).sum(-1) + torch.where(
        in1, TH_SCORE - chi2_1, zero).sum(-1)
    return score, in1 & in2


# ---------------------------------------------------------------------------
# Hypothesis decomposition
# ---------------------------------------------------------------------------

def decompose_essential(E: torch.Tensor):
    """4 (R, t) hypotheses from an essential matrix (DecomposeE), computed
    in float64 and returned in E's dtype."""
    dtype, E = E.dtype, E.double()
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    t = t / torch.linalg.norm(t).clamp_min(1e-12)
    return (torch.stack([R1, R1, R2, R2]).to(dtype),
            torch.stack([t, -t, t, -t]).to(dtype))


def decompose_homography(H21: torch.Tensor, K: torch.Tensor):
    """8 (R, t) hypotheses via the Faugeras SVD decomposition (ReconstructH),
    computed in float64 and returned in H21's dtype."""
    dtype, H21, K = H21.dtype, H21.double(), K.double()
    A = torch.linalg.inv(K) @ H21 @ K
    U, S, Vt = torch.linalg.svd(A)
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1, d2, d3 = S[0], S[1], S[2]
    dt = A.dtype
    dev = A.device
    x1 = torch.sqrt(((d1 * d1 - d2 * d2) / (d1 * d1 - d3 * d3).clamp_min(1e-12)
                     ).clamp_min(0.0))
    x3 = torch.sqrt(((d2 * d2 - d3 * d3) / (d1 * d1 - d3 * d3).clamp_min(1e-12)
                     ).clamp_min(0.0))
    e1 = torch.tensor([1.0, -1.0, 1.0, -1.0], dtype=dt, device=dev)
    e3 = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=dt, device=dev)
    z4, o4 = torch.zeros(4, dtype=dt, device=dev), torch.ones(4, dtype=dt, device=dev)
    root = torch.sqrt(((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3)).clamp_min(0.0))

    def rt_case(positive: bool):
        if positive:   # d' = d2
            stheta = root / ((d1 + d3) * d2).clamp_min(1e-12)
            ctheta = (d2 * d2 + d1 * d3) / ((d1 + d3) * d2).clamp_min(1e-12)
            st = e1 * e3 * stheta
            c4 = ctheta.expand(4)
            Rp = torch.stack([torch.stack([c4, z4, -st], -1),
                              torch.stack([z4, o4, z4], -1),
                              torch.stack([st, z4, c4], -1)], -2)
            tp = torch.stack([e1 * x1, z4, -e3 * x3], -1) * (d1 - d3)
        else:          # d' = -d2
            sphi = root / ((d1 - d3) * d2).clamp_min(1e-12)
            cphi = (d1 * d3 - d2 * d2) / ((d1 - d3) * d2).clamp_min(1e-12)
            sp = e1 * e3 * sphi
            c4 = cphi.expand(4)
            Rp = torch.stack([torch.stack([c4, z4, sp], -1),
                              torch.stack([z4, -o4, z4], -1),
                              torch.stack([sp, z4, -c4], -1)], -2)
            tp = torch.stack([e1 * x1, z4, e3 * x3], -1) * (d1 + d3)
        R = s * (U @ Rp @ Vt)
        t = tp @ U.T
        t = t / torch.linalg.norm(t, dim=-1, keepdim=True).clamp_min(1e-12)
        return R, t

    Ra, ta = rt_case(True)
    Rb, tb = rt_case(False)
    return torch.cat([Ra, Rb]).to(dtype), torch.cat([ta, tb]).to(dtype)


# ---------------------------------------------------------------------------
# Cheirality / parallax check (CheckRT)
# ---------------------------------------------------------------------------

def check_rt(R, t, x1, x2, valid, K, sigma=SIGMA):
    """Triangulate under hypothesis (R, t) and count good points.

    Returns (n_good, good_mask, points3d, parallax_deg_med50)."""
    dt, dev = K.dtype, K.device
    P1 = K @ torch.cat([torch.eye(3, dtype=dt, device=dev),
                        torch.zeros((3, 1), dtype=dt, device=dev)], 1)
    P2 = K @ torch.cat([R, t[:, None]], 1)
    X = geo.triangulate_dlt(P1, P2, x1, x2)                       # (N, 3)
    finite = torch.isfinite(X).all(-1)
    O2 = -R.T @ t
    n1 = X
    n2 = X - O2
    d1 = torch.linalg.norm(n1, dim=-1)
    d2 = torch.linalg.norm(n2, dim=-1)
    cos_par = (n1 * n2).sum(-1) / (d1 * d2).clamp_min(1e-12)
    z1 = X[:, 2]
    z2 = (X @ R.T + t)[:, 2]
    th2 = 4.0 * sigma * sigma

    def reproj(P):
        x = torch.cat([X, torch.ones_like(X[:, :1])], 1) @ P.T
        w = x[:, 2:3]
        return x[:, :2] / torch.where(w.abs() < 1e-8, torch.full_like(w, 1e-8), w)

    e1 = ((reproj(P1) - x1) ** 2).sum(-1)
    e2 = ((reproj(P2) - x2) ** 2).sum(-1)
    good = (valid & finite & (z1 > 0) & (z2 > 0) & (e1 < th2) & (e2 < th2)
            & (cos_par < 0.99998))
    n_good = good.sum().to(torch.int32)
    par_deg = torch.rad2deg(torch.arccos(cos_par.clamp(-1.0, 1.0)))
    par_sorted = torch.sort(torch.where(good, par_deg, torch.full_like(par_deg, 1e9)))[0]
    idx = torch.clamp(n_good - 1, min=0).clamp(max=49)
    return n_good, good, X, par_sorted[idx]


# ---------------------------------------------------------------------------
# Full initialization, in kernel X's four stages
# ---------------------------------------------------------------------------

class InitResult(NamedTuple):
    success: torch.Tensor          # () bool
    used_homography: torch.Tensor  # () bool
    T21: torch.Tensor              # (4, 4) pose of frame 2 wrt frame 1 (t unit-norm)
    points3d: torch.Tensor         # (N, 3) triangulated points (frame-1 camera coords)
    good: torch.Tensor             # (N,) bool triangulated-point mask


class Hypotheses(NamedTuple):
    H21: torch.Tensor     # (N_ITERS, 3, 3) denormalized
    F21: torch.Tensor     # (N_ITERS, 3, 3) denormalized, rank 2
    h_scores: torch.Tensor
    f_scores: torch.Tensor


class Candidates(NamedTuple):
    Rs: torch.Tensor      # (8, 3, 3) the chosen model's poses
    ts: torch.Tensor      # (8, 3)
    mask: torch.Tensor    # (8,) bool: 8 for H, the first 4 for F
    use_h: torch.Tensor   # () bool
    H_best: torch.Tensor  # (3, 3) the refit H
    F_best: torch.Tensor  # (3, 3) the refit F


class Checked(NamedTuple):
    n_good: torch.Tensor    # (8,) int32, -1 where masked
    good: torch.Tensor      # (8, N) bool
    X: torch.Tensor         # (8, N, 3)
    parallax: torch.Tensor  # (8,) degrees


def hypotheses(x1, x2, valid, samples) -> Hypotheses:
    """Stage 1: every H and F minimal-set hypothesis, denormalized and
    scored against all correspondences."""
    x1n, T1 = normalize_points(x1, valid)
    x2n, T2 = normalize_points(x2, valid)
    T2inv = torch.linalg.inv(T2.double())
    p1, p2 = x1n[samples.long()], x2n[samples.long()]
    H21 = _denormalize(_h_dlt64(p1, p2), T2inv, T1)
    h_scores, _ = score_homography(H21, x1[None], x2[None], valid[None])
    F21 = _denormalize(_f_8point64(p1, p2), T2.T, T1)
    f_scores, _ = score_fundamental(F21, x1[None], x2[None], valid[None])
    return Hypotheses(H21, F21, h_scores, f_scores)


def refine(hyp: Hypotheses, x1, x2, valid, K) -> Candidates:
    """Stage 2: the best H and F (first on ties), their weighted all-inlier
    refits, the model choice and the chosen model's candidate poses."""
    x1n, T1 = normalize_points(x1, valid)
    x2n, T2 = normalize_points(x2, valid)
    T2inv = torch.linalg.inv(T2.double())
    best_h = torch.argmax(hyp.h_scores)
    best_f = torch.argmax(hyp.f_scores)
    SH, SF = hyp.h_scores[best_h], hyp.f_scores[best_f]
    _, h_inl = score_homography(hyp.H21[best_h], x1, x2, valid)
    H_best = _denormalize(_h_dlt64(x1n, x2n, w=h_inl.to(x1.dtype)), T2inv, T1)
    _, f_inl = score_fundamental(hyp.F21[best_f], x1, x2, valid)
    F_best = _denormalize(_f_8point64(x1n, x2n, w=f_inl.to(x1.dtype)), T2.T, T1)
    use_h = SH / (SH + SF).clamp_min(1e-12) > 0.40
    K64 = K.double()
    Rs_f, ts_f = (r.float() for r in decompose_essential(
        K64.T @ F_best.double() @ K64))
    Rs_h, ts_h = decompose_homography(H_best, K)
    mask_f = torch.tensor([True] * 4 + [False] * 4, device=x1.device)
    Rs = torch.where(use_h, Rs_h, torch.cat([Rs_f, Rs_f]))
    ts = torch.where(use_h, ts_h, torch.cat([ts_f, ts_f]))
    mask = torch.where(use_h, torch.ones_like(mask_f), mask_f)
    return Candidates(Rs, ts, mask, use_h, H_best, F_best)


def check_hypotheses(cand: Candidates, x1, x2, valid, K) -> Checked:
    """Stage 3: ``check_rt`` for each candidate pose."""
    out = [check_rt(R, t, x1, x2, valid, K) for R, t in zip(cand.Rs, cand.ts)]
    n_good = torch.stack([o[0] for o in out])
    n_good = torch.where(cand.mask, n_good, torch.full_like(n_good, -1))
    return Checked(n_good, torch.stack([o[1] for o in out]),
                   torch.stack([o[2] for o in out]), torch.stack([o[3] for o in out]))


def select(chk: Checked, cand: Candidates, valid) -> InitResult:
    """Stage 4: the best candidate and the acceptance gates (a clear
    winner, enough points, enough parallax)."""
    order = torch.argsort(-chk.n_good, stable=True)
    bi = order[0]
    n_best, n_second = chk.n_good[bi], chk.n_good[order[1]]
    n_valid = valid.sum().to(torch.int32)
    # (0.5 * n_valid instead of the reference's 0.9: the matcher is stricter
    # than the reference's window search, as in the JAX package)
    min_good = torch.clamp((0.5 * n_valid.float()).to(torch.int32),
                           min=MIN_TRIANGULATED)
    success = ((n_best >= min_good)
               & (n_second.float() < 0.75 * n_best.float())
               & (chk.parallax[bi] > MIN_PARALLAX_DEG))
    return InitResult(success, cand.use_h, geo.se3_from_rt(cand.Rs[bi], cand.ts[bi]),
                      chk.X[bi], chk.good[bi] & success)


def initialize_two_view(x1, x2, valid, K, samples) -> InitResult:
    """Two-view SfM bootstrap from matched undistorted pixel coords.

    x1, x2: (N, 2) matched keypoint coords in frames 1 and 2; valid (N,)
    bool; K (3, 3); samples (N_ITERS, 8) int32 indices of the minimal sets
    (drawn on the host)."""
    hyp = hypotheses(x1, x2, valid, samples)
    cand = refine(hyp, x1, x2, valid, K)
    return select(check_hypotheses(cand, x1, x2, valid, K), cand, valid)
