"""How the float32 CG essential graph behaves on the scale map's loop graph.

    python -m orbslam2_tpu_torch.utils.cg_study [--device cpu] [--perturb 4]

Builds the graph that ``chip_smoke.py``'s scale phase hands the loop closer
(``scale_loop_graph``: the 1300-keyframe corridor of
``utils/synthetic.corridor_map`` at the RGB-D configuration's camera, its
stored poses drifted 4 mm a link along the corridor, a loop edge from the
last keyframe to the first, the last keyframe given its true pose; 1300
slots, 9073 edges) and runs the plain version of kernel P'
(``ops/pose_graph.py`` with ``solver="cg"``) on it. It prints:

- the far end's centre error over its start: after the closed-form start
  (no LM iteration), after 20 LM iterations in float32 and in float64, and
  after 20 in float32 from starts whose translations moved by 1e-7 of
  themselves (``--perturb`` of them), with how far the pose vectors of a
  run with one CG iteration a solve (``max_cg=1``) move under that change;
- at the first LM iteration whose float32 CG meets its cap: the relative
  residual ||(H + lam I) v - b|| / ||b|| of the float32 CG's step and of a
  float64 CG's on the same float32 blocks, and how far a 1e-7 change of b
  moves the step after 1, 2 and 600 CG iterations;
- at the first LM iteration, the float64 CG on the float32 blocks.

Runs on the CPU in about five minutes on 8 threads (``--device cuda`` runs
it on the card).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..ops import geometry as geo
from ..ops import pose_graph as pg
from ..ops import sim3_np

SCALE_KFS = 1300
DRIFT = 0.004  # m a link along the corridor's forward axis


def scale_loop_graph(device="cpu"):
    """The loop closer's pose-graph arguments (args, kwargs) on the scale
    map, the last keyframe's slot and its true camera centre."""
    from .. import loop_closing
    from ..loop_closing import LoopCloser
    from ..map.keyframe_database import KeyFrameDatabase
    from ..map.state import MapState
    from ..models.camera import Camera
    from . import slices
    from .synthetic import corridor_map, corridor_pose, integrate_drift

    cfg = slices.config("rgbd")
    c = cfg.camera
    cam = Camera.create(c.fx, c.fy, c.cx, c.cy, bf=c.bf, width=c.width,
                        height=c.height)
    m = MapState.allocate(cfg, device=device)
    kf_ids = corridor_map(m, SCALE_KFS, c.fx, c.fy, c.cx, c.cy, p_new=120,
                          span=8, depth=(7.0, 14.0))
    S = sim3_np.from_se3(m.kf_pose[kf_ids].astype(np.float32))
    links = sim3_np.compose(S[1:], sim3_np.inverse(S[:-1])).astype(np.float32)
    drift = np.zeros(7, np.float32)
    drift[2] = DRIFT
    m.kf_pose[kf_ids] = sim3_np.to_se3(integrate_drift(links, S[0], drift))
    first, last = kf_ids[0], kf_ids[-1]
    m.loop_edges.append((last, first))
    m.dev_kf.ensure(m)
    closer = LoopCloser(cfg, m, cam, KeyFrameDatabase(m, device=device))
    true_last = corridor_pose(SCALE_KFS - 1)
    got = {}

    class Captured(Exception):
        pass

    def capture(*a, **k):
        got["args"] = (a, k)
        raise Captured

    solve = loop_closing._pose_graph.optimize_pose_graph
    loop_closing._pose_graph.optimize_pose_graph = capture
    try:
        closer._optimize_essential_graph(last, first, {},
                                         {last: sim3_np.from_se3(true_last)})
    except Captured:
        pass
    finally:
        loop_closing._pose_graph.optimize_pose_graph = solve
    a, k = got["args"]
    return list(a[:7]), dict(k), last, np.linalg.inv(true_last)[:3, 3]


def lm_states(args, kw, iters, dtype=torch.float32):
    """The plain LM loop of ``pg.optimize_pose_graph`` (CG solver), keeping
    each iteration's system: returns (poses, CG iterations, [(x, lam,
    Hii, Hjj, Hij, b, chain factor)])."""
    S_init, fixed, valid, ei, ej, Sij, ev = (
        t.to(dtype) if t.is_floating_point() else t for t in args)
    order = kw["order"].long()
    x, S0, W_inv, M_e, freeze, M_ch = pg.prepare(
        S_init, fixed, valid, ei, ej, Sij, ev, kw["fix_scale"], order)
    edges = (ei, ej, M_e, Sij, ev)
    lam = torch.tensor(1e-8, dtype=dtype, device=S_init.device)
    cost = pg.edge_cost(x, *edges)
    its, states = [], []
    for _ in range(iters):
        Hii, Hjj, Hij, b = pg.edge_blocks(x, *edges, freeze)
        ch = pg.chain_factor(x, M_ch, order, freeze)
        states.append((x, lam, Hii, Hjj, Hij, b, ch))
        v, n = pg.cg_solve(Hii, Hjj, Hij, b, ei, ej, lam, freeze, order, *ch)
        its.append(n)
        x_new = pg.apply_step(x, -v, freeze, kw["fix_scale"])
        cost_new = pg.edge_cost(x_new, *edges)
        accept = cost_new < cost
        x = torch.where(accept, x_new, x)
        lam = torch.where(accept, (lam * 0.2).clamp_min(1e-12), lam * 4.0)
        cost = torch.where(accept, cost_new, cost)
    K = x.shape[0]
    S = geo.sim3_compose(geo.sim3_compose(geo.sim3_exp(x), S0), W_inv.expand(K, 8))
    return S, its, states


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--perturb", type=int, default=4)
    args_ns = ap.parse_args(argv)
    dev = torch.device(args_ns.device)
    t0 = time.perf_counter()
    args, kw, last, c_true = scale_loop_graph(dev)
    ei, ej, freeze = args[3], args[4], args[1] | ~args[2]
    order = kw["order"].long()

    def far(S):
        R, t, s = geo.sim3_R(S[last]), geo.sim3_t(S[last]), geo.sim3_s(S[last])
        c = -(R.T @ t) / s
        return float(np.linalg.norm(c.double().cpu().numpy() - c_true))

    e0 = far(args[0])
    print(f"graph: K={args[0].shape[0]}, E={ei.shape[0]}, far end {e0:.4f} m "
          f"({time.perf_counter() - t0:.1f} s to build)")
    S, _, _ = lm_states(args, kw, 0)
    print(f"after the closed-form start: far end / start {far(S) / e0:.3e}")
    S, its, states = lm_states(args, kw, 20)
    print(f"float32, 20 LM iterations: far end / start {far(S) / e0:.4f}; CG "
          f"iterations {its}")
    S, its64, _ = lm_states(args, kw, 20, torch.float64)
    print(f"float64, 20 LM iterations: far end / start {far(S) / e0:.4f}; CG "
          f"iterations {its64}")
    g = torch.Generator(device=dev).manual_seed(0)
    for i in range(args_ns.perturb):
        a = list(args)
        a[0] = args[0].clone()
        a[0][:, 4:7] *= 1 + 1e-7 * torch.randn(a[0][:, 4:7].shape, generator=g,
                                               device=dev)
        S, its_p, _ = lm_states(a, kw, 20)
        one = (pg.optimize_pose_graph(*a, **kw, solver="cg", max_cg=1).poses
               - pg.optimize_pose_graph(*args, **kw, solver="cg", max_cg=1).poses)
        print(f"float32, start moved by 1e-7 ({i}): far end / start "
              f"{far(S) / e0:.4f}; {sum(its_p)} CG iterations; one CG iteration "
              f"a solve: pose vectors moved by {one.abs().max().item():.2e}")

    def study(k, label):
        x, lam, Hii, Hjj, Hij, b, ch = states[k]
        H = pg.pair_blocks(Hii, Hjj, Hij).double()

        def residual(v):
            r = pg.matvec(H, v.double(), ei, ej, lam.double(), freeze) - b.double()
            return (r.norm() / b.double().norm()).item()

        vd, nd = pg.cg_solve(*(t.double() for t in (Hii, Hjj, Hij, b)), ei, ej,
                             lam.double(), freeze, order, *(t.double() for t in ch))
        line = [f"LM iteration {k + 1} ({label}, lam {lam.item():.2e}): float64 "
                f"CG on the float32 blocks: {nd} iterations, relative residual "
                f"{residual(vd):.3e}"]
        for cap in (1, 2, None):
            v, n = pg.cg_solve(Hii, Hjj, Hij, b, ei, ej, lam, freeze, order, *ch,
                               max_cg=cap)
            moved = []
            for _ in range(3):
                bp = b * (1 + 1e-7 * torch.randn(b.shape, generator=g, device=dev))
                vp, _ = pg.cg_solve(Hii, Hjj, Hij, bp, ei, ej, lam, freeze, order,
                                    *ch, max_cg=cap)
                moved.append(((vp - v).norm() / v.norm()).item())
            line.append(f"float32 CG, {n} iterations: relative residual "
                        f"{residual(v):.3e}, step moved by "
                        + ", ".join(f"{d:.2e}" for d in moved)
                        + " of itself under a 1e-7 change of b")
        print("; ".join(line))

    study(0, "the first")
    capped = [i for i, n in enumerate(its) if n == min(args[0].shape[0], 600)]
    if capped:
        study(capped[0], "the first to meet the CG cap")
    print(f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
