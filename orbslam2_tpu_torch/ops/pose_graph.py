"""7-DoF Sim3 pose-graph (essential graph) optimization, dense solver (port
of ``orbslam2_tpu.ops.pose_graph``, plain PyTorch; kernel P,
``kernels/pose_graph.py``, runs it on the card).

Every keyframe pose is a Sim3 vertex, connected by relative-Sim3 edges
(spanning tree, strong covisibility, loop edges) with identity information;
20 LM iterations. As the reference, the solver optimizes small left
corrections x_k (S_k = exp(x_k) S0_k) of a recentred base S0 = S_init W,
with the base-relative edge transforms M_ij = S0_j S0_i^-1 folded once;
the start is the better (by total cost) of zero, the chain re-integration
of the measured temporal links, and the loop-aware ramp on top of it. Each
iteration linearizes every edge (forward-mode autodiff of the residual
log(S_ij exp(d_j) exp(x_j) M_ij exp(-x_i) exp(-d_i)) at d = 0), assembles
the dense (7K, 7K) normal equations with frozen vertices as identity rows,
solves them and keeps the step if the total cost falls.

K <= DENSE_MAX_K only: the reference's matrix-free PCG for larger graphs
comes with ROADMAP slice 8b.
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


def check_dense(K: int):
    if K > DENSE_MAX_K:
        raise NotImplementedError(
            f"pose graph with K={K} > {DENSE_MAX_K} vertices: the conjugate-"
            "gradient solver comes with ROADMAP slice 8b")


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
    M_e (E, 8), freeze (K,))."""
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
    M_ch = geo.sim3_compose(S0p, geo.sim3_inverse(torch.roll(S0p, 1, 0)))
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
    return x_init, S0, W_inv, M_e, freeze


def normal_equations(x, lam, edge_i, edge_j, M_e, edge_Sij, edge_valid, freeze):
    """(H (7K, 7K), b (7K,)) of one LM iteration: the per-edge blocks
    assembled densely, frozen vertices as identity rows, + lam I."""
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


def optimize_pose_graph(S_init, fixed, valid, edge_i, edge_j, edge_Sij,
                        edge_valid, iters: int = 20, fix_scale: bool = False,
                        order: Optional[torch.Tensor] = None) -> PoseGraphResult:
    K = S_init.shape[0]
    check_dense(K)
    x, S0, W_inv, M_e, freeze = prepare(S_init, fixed, valid, edge_i, edge_j,
                                        edge_Sij, edge_valid, fix_scale, order)
    edges = (edge_i, edge_j, M_e, edge_Sij, edge_valid)
    lam = torch.tensor(1e-8, dtype=S_init.dtype, device=S_init.device)
    cost = edge_cost(x, *edges)
    for _ in range(iters):
        H, b = normal_equations(x, lam, *edges, freeze)
        dx = -torch.linalg.solve(H, b).reshape(K, D)
        x_new = apply_step(x, dx, freeze, fix_scale)
        cost_new = edge_cost(x_new, *edges)
        accept = cost_new < cost
        x = torch.where(accept, x_new, x)
        lam = torch.where(accept, (lam * 0.2).clamp_min(1e-12), lam * 4.0)
        cost = torch.where(accept, cost_new, cost)
    S = geo.sim3_compose(geo.sim3_compose(geo.sim3_exp(x), S0), W_inv.expand(K, 8))
    return PoseGraphResult(poses=S, cost=cost)
