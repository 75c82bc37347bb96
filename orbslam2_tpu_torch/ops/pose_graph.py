"""7-DoF Sim3 pose-graph (essential graph) optimization (port of
``orbslam2_tpu.ops.pose_graph``, plain PyTorch; kernel P,
``kernels/pose_graph.py``, runs the dense solver on the card and kernel P',
``kernels/pose_graph_cg.py``, the conjugate-gradient one).

Every keyframe pose is a Sim3 vertex, connected by relative-Sim3 edges
(spanning tree, strong covisibility, loop edges) with identity information;
20 LM iterations. As the reference, the solver optimizes small left
corrections x_k (S_k = exp(x_k) S0_k) of a recentred base S0 = S_init W,
with the base-relative edge transforms M_ij = S0_j S0_i^-1 folded once;
the start is the better (by total cost) of zero, the chain re-integration
of the measured temporal links, and the loop-aware ramp on top of it. Each
iteration linearizes every edge (forward-mode autodiff of the residual
log(S_ij exp(d_j) exp(x_j) M_ij exp(-x_i) exp(-d_i)) at d = 0) into its
7x7 blocks, solves for a step and keeps it if the total cost falls. The
step comes from one of two solvers, chosen by K = S_init.shape[0] (every
slot, dead ones included) as the reference chooses:

- K <= DENSE_MAX_K: the dense (7K, 7K) normal equations with frozen
  vertices as identity rows, one solve;
- larger K: matrix-free preconditioned conjugate gradients. The
  preconditioner is the exact inverse of the temporal chain's Hessian
  (pseudo-edges between consecutive vertices of ``order``): its factor is
  block-bidiagonal, so applying it is two affine recurrences
  x_k = M_k x_{k-1} + c_k, backward then forward, each evaluated as a
  log-depth doubling scan whose matrix products are formed once per LM
  iteration. CG then resolves the off-chain edges (loop, covisibility).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import geometry as geo

DENSE_MAX_K = 384
D = 7


class PoseGraphResult(NamedTuple):
    poses: torch.Tensor  # (K, 8) optimized Sim3 vectors
    cost: torch.Tensor


def edge_residual(d_i, d_j, x_i, x_j, M_ij, S_ij):
    """e = log(S_ij exp(d_j) exp(x_j) M_ij exp(-x_i) exp(-d_i)), batched
    over (E, ...)."""
    A = geo.sim3_compose(S_ij, geo.sim3_exp(d_j))
    A = geo.sim3_compose(A, geo.sim3_exp(x_j))
    A = geo.sim3_compose(A, M_ij)
    A = geo.sim3_compose(A, geo.sim3_exp(-x_i))
    A = geo.sim3_compose(A, geo.sim3_exp(-d_i))
    return geo.sim3_log(A)


def edge_lin(x_i, x_j, M_ij, S_ij):
    """Residuals (E, 7) at d = 0 and the Jacobians (E, 7, 7) with respect
    to d_i and d_j, by forward-mode autodiff (one jvp per tangent
    direction, batched over the edges and the 7 directions)."""
    z = torch.zeros_like(x_i)
    basis = torch.eye(D, dtype=x_i.dtype, device=x_i.device)[:, None, :].expand(
        D, x_i.shape[0], D)

    def column(f):
        return torch.func.vmap(lambda t: torch.func.jvp(f, (z,), (t,))[1])(basis)

    r = edge_residual(z, z, x_i, x_j, M_ij, S_ij)
    Ji = column(lambda d: edge_residual(d, z, x_i, x_j, M_ij, S_ij))
    Jj = column(lambda d: edge_residual(z, d, x_i, x_j, M_ij, S_ij))
    # (7 directions, E, 7 residual rows) -> (E, rows, directions)
    return r, Ji.permute(1, 2, 0), Jj.permute(1, 2, 0)


def prepare(S_init, fixed, valid, edge_i, edge_j, edge_Sij, edge_valid,
            fix_scale: bool = False, order: Optional[torch.Tensor] = None):
    """The closed-form start: gauge recentring, base-relative edge
    transforms, chain re-integration and the loop-aware ramp, each guarded
    by the total cost. Returns (x_init (K, 7), S0 (K, 8), W_inv (8,),
    M_e (E, 8), freeze (K,), M_ch (K, 8)), M_ch being the chain's
    base-relative links S0p_k S0p_{k-1}^-1 in ``order``."""
    K = S_init.shape[0]
    dt, dev = S_init.dtype, S_init.device
    if order is None:
        order = torch.arange(K, device=dev)
    order = order.long()
    ei, ej = edge_i.long(), edge_j.long()
    ew = edge_valid.to(dt)
    freeze = fixed | ~valid

    # gauge recentring
    R = geo.sim3_R(S_init)
    centers = -(R.transpose(-1, -2) @ geo.sim3_t(S_init)[..., None])[..., 0] \
        / geo.sim3_s(S_init)[:, None]
    vw = valid.to(dt)[:, None]
    n_valid = vw.sum().clamp_min(1.0)
    c0 = (centers * vw).sum(0) / n_valid
    L = torch.sqrt((((centers - c0) ** 2).sum(1) * vw[:, 0]).sum() / n_valid)
    L = L.clamp_min(1.0)
    W = geo.sim3_make(L.reshape(1), torch.eye(3, dtype=dt, device=dev)[None],
                      c0[None])                               # x -> L x + c0
    W_inv = geo.sim3_inverse(W)[0]
    S0 = geo.sim3_compose(S_init, W.expand(K, 8))

    # base-relative edge transforms
    M_e = geo.sim3_compose(S0[ej], geo.sim3_inverse(S0[ei]))

    def total_cost(x):
        z = torch.zeros_like(x[ei])
        r = edge_residual(z, z, x[ei], x[ej], M_e, edge_Sij)
        return ((r * r).sum(1) * ew).sum(), r

    # chain re-integration: re-compose the measured temporal links
    inv_ord = torch.argsort(order)
    S0p = S0[order]
    M_ch = chain_links(S0, order)
    a_ids, b_ids = order, torch.roll(order, 1)
    live = edge_valid[None, :]

    def lookup(a, b):
        hit = (ei[None, :] == a[:, None]) & (ej[None, :] == b[:, None]) & live
        return torch.where(hit.any(1), hit.to(torch.int8).argmax(1),
                           torch.full_like(a, -1))

    fwd, rev = lookup(a_ids, b_ids), lookup(b_ids, a_ids)
    R_link = torch.where(
        (fwd >= 0)[:, None], edge_Sij[fwd.clamp_min(0)],
        torch.where((rev >= 0)[:, None],
                    geo.sim3_inverse(edge_Sij[rev.clamp_min(0)]), M_ch))
    R_link[0] = geo.sim3_identity(dt, dev)
    Q = [R_link[0]]
    for k in range(1, K):      # Q_k = R_k Q_{k-1}
        Q.append(geo.sim3_compose(R_link[k][None], Q[-1][None])[0])
    S_int = geo.sim3_compose(torch.stack(Q), S0p[0].expand(K, 8))
    x_int = geo.sim3_log(geo.sim3_compose(S_int, geo.sim3_inverse(S0p)))[inv_ord]
    x_int = torch.where(freeze[:, None], torch.zeros_like(x_int), x_int)
    x_zero = torch.zeros((K, D), dtype=dt, device=dev)
    c_int, _ = total_cost(x_int)
    c_zero, _ = total_cost(x_zero)
    x_best = torch.where(c_int < c_zero, x_int, x_zero)

    # loop-aware ramp along the chain from the strongest long-range edge
    pos = inv_ord
    c_best, r0 = total_cost(x_best)
    span = (pos[ei] - pos[ej]).abs().to(dt)
    score = torch.linalg.norm(r0, dim=1) * span * ew
    eidx = score.argmax()
    li, lj = ei[eidx], ej[eidx]
    e_loop = r0[eidx].clone()
    if fix_scale:
        e_loop[6] = 0.0
    swap = pos[li] > pos[lj]
    pa = torch.minimum(pos[li], pos[lj]).to(dt)
    pb = torch.maximum(pos[li], pos[lj]).to(dt)
    Si = geo.sim3_compose(geo.sim3_exp(x_best[li][None]), S0[li][None])
    Gfull = geo.sim3_compose(geo.sim3_inverse(Si), geo.sim3_compose(
        geo.sim3_exp(torch.where(swap, e_loop, -e_loop)[None]), Si))
    gvec = geo.sim3_log(Gfull)[0]
    w = ((pos.to(dt) - pa) / (pb - pa).clamp_min(1.0)).clamp(0.0, 1.0)
    w = torch.where(freeze, torch.zeros_like(w), w)
    x_ramp = geo.sim3_log(geo.sim3_compose(geo.sim3_exp(x_best), geo.sim3_compose(
        S0, geo.sim3_compose(geo.sim3_exp(w[:, None] * gvec[None]),
                             geo.sim3_inverse(S0)))))
    c_ramp, _ = total_cost(x_ramp)
    x_init = torch.where(c_ramp < c_best, x_ramp, x_best)
    return x_init, S0, W_inv, M_e, freeze, M_ch


def chain_links(S0, order):
    """The chain's relative base poses M_ch (K, 8): position k's base
    times the inverse of position k - 1's (position 0: the last's)."""
    S0p = S0[order]
    return geo.sim3_compose(S0p, geo.sim3_inverse(torch.roll(S0p, 1, 0)))


def edge_blocks(x, edge_i, edge_j, M_e, edge_Sij, edge_valid, freeze):
    """The per-edge normal-equation blocks Hii, Hjj, Hij (E, 7, 7) of one
    LM iteration (zero for invalid edges) and the gradient b (K, 7), zero
    on frozen rows."""
    K = x.shape[0]
    ei, ej = edge_i.long(), edge_j.long()
    ew = edge_valid.to(x.dtype)
    r, Ji, Jj = edge_lin(x[ei], x[ej], M_e, edge_Sij)
    Jiw = Ji * ew[:, None, None]
    Jjw = Jj * ew[:, None, None]
    Hii = Jiw.transpose(1, 2) @ Ji
    Hjj = Jjw.transpose(1, 2) @ Jj
    Hij = Jiw.transpose(1, 2) @ Jj
    bi = (Jiw.transpose(1, 2) @ r[..., None])[..., 0]
    bj = (Jjw.transpose(1, 2) @ r[..., None])[..., 0]
    b = torch.zeros((K, D), dtype=x.dtype, device=x.device)
    b.index_add_(0, ei, bi)
    b.index_add_(0, ej, bj)
    b = torch.where(freeze[:, None], torch.zeros_like(b), b)
    return Hii, Hjj, Hij, b


def normal_equations(x, lam, edge_i, edge_j, M_e, edge_Sij, edge_valid, freeze):
    """(H (7K, 7K), b (7K,)) of one LM iteration: the per-edge blocks
    assembled densely, frozen vertices as identity rows, + lam I."""
    K = x.shape[0]
    ei, ej = edge_i.long(), edge_j.long()
    Hii, Hjj, Hij, b = edge_blocks(x, edge_i, edge_j, M_e, edge_Sij, edge_valid,
                                   freeze)
    H = torch.zeros((K, K, D, D), dtype=x.dtype, device=x.device)
    H.index_put_((ei, ei), Hii, accumulate=True)
    H.index_put_((ej, ej), Hjj, accumulate=True)
    H.index_put_((ei, ej), Hij, accumulate=True)
    H.index_put_((ej, ei), Hij.transpose(1, 2), accumulate=True)
    H = torch.where(freeze[:, None, None, None] | freeze[None, :, None, None],
                    torch.zeros_like(H), H)
    eye = torch.eye(D, dtype=x.dtype, device=x.device)
    diag = torch.arange(K, device=x.device)
    H[diag, diag] += freeze.to(x.dtype)[:, None, None] * eye + lam * eye
    return H.permute(0, 2, 1, 3).reshape(K * D, K * D), b.reshape(-1)


def apply_step(x, dx, freeze, fix_scale: bool):
    """Fold a step into the corrections: x' = log(exp(dx) exp(x))."""
    if fix_scale:
        dx = dx.clone()
        dx[:, 6] = 0.0
    dx = torch.where(freeze[:, None], torch.zeros_like(dx), dx)
    return geo.sim3_log(geo.sim3_compose(geo.sim3_exp(dx), geo.sim3_exp(x)))


def edge_cost(x, edge_i, edge_j, M_e, edge_Sij, edge_valid):
    ei, ej = edge_i.long(), edge_j.long()
    z = torch.zeros_like(x[ei])
    r = edge_residual(z, z, x[ei], x[ej], M_e, edge_Sij)
    return ((r * r).sum(1) * edge_valid.to(x.dtype)).sum()


def chain_factor(x, M_ch, order, freeze):
    """The chain preconditioner's factor at corrections x: (Ainv, M_fwd,
    M_bwd), each (K, 7, 7) in chain order. A pseudo-edge joins chain
    position k to k - 1 (position 0 to the last, harmless because position
    0 is anchored), measured by the current relative pose; A and B are its
    Jacobians. Anchored rows (frozen vertices and position 0) get A = I and
    B = 0, and a row whose predecessor is anchored gets B = 0. Then
    M_fwd = -A^-1 B and M_bwd_k = -A_k^-T B_{k+1}^T (zero at the end)."""
    K = x.shape[0]
    xp = x[order]
    xprev = torch.roll(xp, 1, 0)
    Spe = geo.sim3_compose(geo.sim3_exp(xp),
                           geo.sim3_compose(M_ch, geo.sim3_exp(-xprev)))
    _, Ach, Bch = edge_lin(xp, xprev, geo.sim3_inverse(M_ch), Spe)
    anchor = freeze[order].clone()
    anchor[0] = True
    eye = torch.eye(D, dtype=x.dtype, device=x.device).expand(K, D, D)
    Ach = torch.where(anchor[:, None, None], eye, Ach)
    cut = anchor | torch.roll(anchor, 1)
    Bch = torch.where(cut[:, None, None], torch.zeros_like(Bch), Bch)
    Ainv = torch.linalg.inv(Ach)
    Bnext = torch.roll(Bch, -1, 0)
    Bnext[-1] = 0.0
    return Ainv, -Ainv @ Bch, -Ainv.transpose(1, 2) @ Bnext.transpose(1, 2)


def scan_levels(M):
    """The matrices of a doubling scan of x_k = M_k x_{k-1} + c_k: level d
    holds, for k >= 2^d, the product M_k M_{k-1} ... M_{k-2^d+1} (rows
    below 2^d are not used). Formed once per LM iteration; each application
    of the scan is then vector work only."""
    K = M.shape[0]
    levels = [M]
    s = 1
    while 2 * s < K:
        cur = levels[-1]
        nxt = cur.clone()
        nxt[2 * s:] = cur[2 * s:] @ cur[s:K - s]
        levels.append(nxt)
        s *= 2
    return levels


def affine_scan(levels, c):
    """x_k = M_k x_{k-1} + c_k with x_{-1} = 0, for every k at once, from
    ``scan_levels(M)``: at level d each x_k with k >= 2^d gains the
    level's product times x_{k-2^d}."""
    for d, A in enumerate(levels):
        s = 1 << d
        nxt = c.clone()
        nxt[s:, :, None].baddbmm_(A[s:], c[:-s, :, None])
        c = nxt
    return c


def pair_blocks(Hii, Hjj, Hij):
    """Each edge's block row pair [[Hii, Hij], [Hij^T, Hjj]] (E, 14, 14)."""
    return torch.cat([torch.cat([Hii, Hij], 2),
                      torch.cat([Hij.transpose(1, 2), Hjj], 2)], 1)


def matvec(H, v, edge_i, edge_j, lam, freeze):
    """(H + lam I) v from the edges' block pairs H (``pair_blocks``), frozen
    rows mapped to themselves."""
    ei, ej = edge_i.long(), edge_j.long()
    ye = (H @ torch.cat([v[ei], v[ej]], 1)[..., None])[..., 0]
    y = torch.zeros_like(v)
    y.index_add_(0, ei, ye[:, :D])
    y.index_add_(0, ej, ye[:, D:])
    return torch.where(freeze[:, None], v, y + lam * v)


def cg_solve(Hii, Hjj, Hij, b, edge_i, edge_j, lam, freeze, order, Ainv,
             M_fwd, M_bwd, max_cg: Optional[int] = None):
    """The reference's PCG for (H + lam I) v = b with frozen rows as
    identity rows: at most min(K, 600) iterations (``max_cg`` if given)
    while the preconditioned residual r.z exceeds 1e-10 of its start.
    Returns (v, iterations)."""
    K = b.shape[0]
    H = pair_blocks(Hii, Hjj, Hij)
    inv_ord = torch.argsort(order)
    fwd, bwd = scan_levels(M_fwd), scan_levels(M_bwd.flip(0))
    AinvT = Ainv.transpose(1, 2)
    fz = freeze[:, None]

    def precond(r):
        rp = r[order]
        # A^T y = rp: the backward recurrence; then A x = y: the forward one
        y = affine_scan(bwd, (AinvT @ rp[..., None])[..., 0].flip(0)).flip(0)
        xs = affine_scan(fwd, (Ainv @ y[..., None])[..., 0])
        return torch.where(fz, r, xs[inv_ord])

    v = torch.zeros_like(b)
    r = b - matvec(H, v, edge_i, edge_j, lam, freeze)
    z = precond(r)
    p = z
    rz = rz0 = (r * z).sum()
    it, cg_max = 0, min(K, 600) if max_cg is None else max_cg
    while it < cg_max and bool(rz > 1e-10 * rz0):
        Ap = matvec(H, p, edge_i, edge_j, lam, freeze)
        alpha = rz / (p * Ap).sum().clamp_min(1e-20)
        v = v + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = (r * z).sum()
        p = z + rz_new / rz.clamp_min(1e-20) * p
        rz = rz_new
        it += 1
    return v, it


def optimize_pose_graph(S_init, fixed, valid, edge_i, edge_j, edge_Sij,
                        edge_valid, iters: int = 20, fix_scale: bool = False,
                        order: Optional[torch.Tensor] = None,
                        solver: str = "auto",
                        max_cg: Optional[int] = None) -> PoseGraphResult:
    """``solver``: "auto" (dense for K <= DENSE_MAX_K, else CG), "dense" or
    "cg". ``order``: the temporal vertex order of the CG chain (creation
    order, dead slots last); slot order by default. ``max_cg``: a cap on
    each CG solve below the reference's min(K, 600) iterations."""
    K = S_init.shape[0]
    if solver not in ("auto", "dense", "cg"):
        raise ValueError(f"solver must be auto, dense or cg, got {solver!r}")
    use_dense = K <= DENSE_MAX_K if solver == "auto" else solver == "dense"
    if order is None:
        order = torch.arange(K, device=S_init.device)
    order = order.long()
    x, S0, W_inv, M_e, freeze, M_ch = prepare(
        S_init, fixed, valid, edge_i, edge_j, edge_Sij, edge_valid, fix_scale,
        order)
    edges = (edge_i, edge_j, M_e, edge_Sij, edge_valid)
    lam = torch.tensor(1e-8, dtype=S_init.dtype, device=S_init.device)
    cost = edge_cost(x, *edges)
    for _ in range(iters):
        if use_dense:
            H, b = normal_equations(x, lam, *edges, freeze)
            dx = -torch.linalg.solve(H, b).reshape(K, D)
        else:
            Hii, Hjj, Hij, b = edge_blocks(x, *edges, freeze)
            v, _ = cg_solve(Hii, Hjj, Hij, b, edge_i, edge_j, lam, freeze, order,
                            *chain_factor(x, M_ch, order, freeze), max_cg=max_cg)
            dx = -v
        x_new = apply_step(x, dx, freeze, fix_scale)
        cost_new = edge_cost(x_new, *edges)
        accept = cost_new < cost
        x = torch.where(accept, x_new, x)
        lam = torch.where(accept, (lam * 0.2).clamp_min(1e-12), lam * 4.0)
        cost = torch.where(accept, cost_new, cost)
    S = geo.sim3_compose(geo.sim3_compose(geo.sim3_exp(x), S0), W_inv.expand(K, 8))
    return PoseGraphResult(poses=S, cost=cost)
