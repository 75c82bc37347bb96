"""Synthetic renderable world for end-to-end SLAM tests and benchmarks.

The reference validates on TUM/KITTI/EuRoC recordings (SURVEY §4.1); those
assets are unavailable offline, so this module provides a deterministic
substitute: a textured box room rendered by per-pixel ray casting with exact
ground-truth poses and depth. Texture is band-limited noise, which gives FAST
plenty of corners and BRIEF distinctive patches.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class Plane:
    """Textured rectangle: point p0, spanning vectors eu/ev (texture axes)."""

    p0: np.ndarray    # (3,) corner
    eu: np.ndarray    # (3,) u axis (length = width in meters)
    ev: np.ndarray    # (3,) v axis
    tex: np.ndarray   # (Th, Tw) float32 texture in [0, 255]


def _make_texture(rng, size=512, blur=1.2, contrast=1.0, style=None):
    """Structured texture: band-limited noise + style-dependent structure.

    Pure blurred noise is isotropic — real scenes have oriented structure
    (posters, furniture edges, brickwork, window grids), which is what makes
    the intensity-centroid orientation stable AND what gives a bag-of-words
    vocabulary its word-usage statistics. Styles (drawn at random when
    unspecified) vary that structure so a vocabulary trained on these worlds
    is not dominated by one patch family:

      rects    — random opaque rectangles (posters / furniture)
      stripes  — oriented bands (fences, siding, blinds)
      bricks   — offset grid of shaded cells (brickwork / windows)
      blobs    — soft elliptical patches (vegetation / stains)
    """
    t = rng.uniform(0, 1, size=(size, size)).astype(np.float32)
    k = max(int(blur * 2) | 1, 3)
    kernel = np.exp(-0.5 * ((np.arange(k) - k // 2) / blur) ** 2)
    kernel /= kernel.sum()
    t = np.apply_along_axis(lambda r: np.convolve(r, kernel, "same"), 1, t)
    t = np.apply_along_axis(lambda c: np.convolve(c, kernel, "same"), 0, t)
    t = (t - t.min()) / max(t.max() - t.min(), 1e-9)
    style = style or rng.choice(["rects", "stripes", "bricks", "blobs"])
    if style == "rects":
        for _ in range(60):
            h = int(rng.integers(8, 60))
            w = int(rng.integers(8, 60))
            y = int(rng.integers(0, size - h))
            x = int(rng.integers(0, size - w))
            shade = rng.uniform(0, 1)
            t[y:y + h, x:x + w] = 0.7 * shade + 0.3 * t[y:y + h, x:x + w]
    elif style == "stripes":
        period = int(rng.integers(14, 48))
        ang = rng.uniform(0, np.pi)
        yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
        phase = (xx * np.cos(ang) + yy * np.sin(ang)) / period
        bands = (phase - np.floor(phase)) < rng.uniform(0.3, 0.7)
        shade = rng.uniform(0, 1)
        t = np.where(bands, 0.65 * shade + 0.35 * t, t)
        for _ in range(20):  # breaks in the stripes -> corners
            h = int(rng.integers(10, 50))
            w = int(rng.integers(10, 50))
            y = int(rng.integers(0, size - h))
            x = int(rng.integers(0, size - w))
            t[y:y + h, x:x + w] = 0.7 * rng.uniform(0, 1) + 0.3 * t[y:y + h, x:x + w]
    elif style == "bricks":
        bh = int(rng.integers(20, 50))
        bw = int(rng.integers(30, 80))
        for r0 in range(0, size, bh):
            off = (r0 // bh % 2) * bw // 2
            for c0 in range(-bw, size, bw):
                sh = rng.uniform(0.2, 1.0)
                y1, x1 = min(r0 + bh - 2, size), min(c0 + off + bw - 2, size)
                y0, x0 = max(r0, 0), max(c0 + off, 0)
                if y1 > y0 and x1 > x0:
                    t[y0:y1, x0:x1] = 0.6 * sh + 0.4 * t[y0:y1, x0:x1]
    else:  # blobs
        yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
        for _ in range(40):
            cy, cx = rng.integers(0, size, 2)
            sy, sx = rng.uniform(6, 40, 2)
            th = rng.uniform(0, np.pi)
            dy, dx = yy - cy, xx - cx
            ry = dy * np.cos(th) - dx * np.sin(th)
            rx = dy * np.sin(th) + dx * np.cos(th)
            mask = (ry / sy) ** 2 + (rx / sx) ** 2 < 1.0
            sh = rng.uniform(0, 1)
            t = np.where(mask, 0.55 * sh + 0.45 * t, t)
    return (20 + 215 * contrast * t).astype(np.float32)


def make_box_room(seed=0, size=6.0, height=3.0, styles="rects") -> List[Plane]:
    """Box room centered at origin: floor, ceiling, four walls.

    styles="rects" (default) reproduces the original noise+rectangles
    texture BIT-EXACTLY (same rng consumption), so every tuned test scene
    is unchanged; styles=None draws a random style per plane (vocabulary
    training corpora want that variety)."""
    rng = np.random.default_rng(seed)
    s, h = size / 2.0, height / 2.0
    e = np.eye(3)
    planes = []

    def add(p0, eu, ev):
        planes.append(
            Plane(np.asarray(p0, np.float32), np.asarray(eu, np.float32),
                  np.asarray(ev, np.float32),
                  _make_texture(rng, style=styles))
        )

    add([-s, +h, -s], e[0] * size, e[2] * size)    # floor (y = +h, y down)
    add([-s, -h, -s], e[0] * size, e[2] * size)    # ceiling
    add([-s, -h, +s], e[0] * size, e[1] * height)  # back wall  (z = +s)
    add([-s, -h, -s], e[0] * size, e[1] * height)  # front wall (z = -s)
    add([-s, -h, -s], e[2] * size, e[1] * height)  # left wall  (x = -s)
    add([+s, -h, -s], e[2] * size, e[1] * height)  # right wall (x = +s)
    return planes


def make_corridor(seed=0, length=120.0, width=8.0, height=5.0,
                  segment=10.0) -> List[Plane]:
    """Street-like corridor along +z: ground plane plus two facade walls
    tiled from `segment`-meter panels with independently drawn textures.

    Panels share texture STYLES (brick rows, stripe periods) while differing
    in detail — the self-similar-but-not-identical structure that makes
    street-scale place recognition hard (KITTI 00's facade problem), which a
    box room cannot reproduce. Drive a camera down +z for a KITTI-ish run."""
    rng = np.random.default_rng(seed)
    w, h = width / 2.0, height
    planes = []

    def add(p0, eu, ev, style=None):
        planes.append(
            Plane(np.asarray(p0, np.float32), np.asarray(eu, np.float32),
                  np.asarray(ev, np.float32),
                  _make_texture(rng, style=style))
        )

    n_seg = max(int(np.ceil(length / segment)), 1)
    # one ground strip per segment (texture variety along the track too)
    for i in range(n_seg):
        z0 = i * segment
        add([-w, 2.0, z0], [width, 0, 0], [0, 0, segment], style="blobs")
        # facades: mostly bricks/stripes — the repeating-structure confusers
        style = ["bricks", "stripes", "rects"][int(rng.integers(0, 3))]
        add([-w, 2.0 - h, z0], [0, 0, segment], [0, h, 0], style=style)
        style = ["bricks", "stripes", "rects"][int(rng.integers(0, 3))]
        add([+w, 2.0 - h, z0], [0, 0, segment], [0, h, 0], style=style)
    return planes


def render(
    planes: List[Plane],
    K: np.ndarray,
    Tcw: np.ndarray,
    width: int,
    height: int,
    return_depth: bool = False,
):
    """Ray-cast the planes into a (H, W) grayscale image (+ depth)."""
    Twc = np.linalg.inv(Tcw)
    Rwc = Twc[:3, :3]
    C = Twc[:3, 3]
    xs, ys = np.meshgrid(np.arange(width), np.arange(height))
    rays_c = np.stack(
        [(xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1], np.ones_like(xs, np.float32)],
        axis=-1,
    ).astype(np.float32)
    rays_w = rays_c @ Rwc.T  # (H, W, 3)

    img = np.zeros((height, width), np.float32)
    depth = np.full((height, width), np.inf, np.float32)
    for pl in planes:
        n = np.cross(pl.eu, pl.ev)
        nn = n / np.linalg.norm(n)
        denom = rays_w @ nn
        t = ((pl.p0 - C) @ nn) / np.where(np.abs(denom) < 1e-9, 1e-9, denom)
        hit = t > 0.05
        pw = C + rays_w * t[..., None]
        rel = pw - pl.p0
        u = rel @ pl.eu / (pl.eu @ pl.eu)
        v = rel @ pl.ev / (pl.ev @ pl.ev)
        inside = hit & (u >= 0) & (u < 1) & (v >= 0) & (v < 1)
        # depth along camera z axis (not ray length)
        z = (pw - C) @ Rwc[:, 2]
        closer = inside & (z < depth) & (z > 0)
        # bilinear texture sample
        Th, Tw = pl.tex.shape
        tu = np.clip(u * (Tw - 1), 0, Tw - 1.001)
        tv = np.clip(v * (Th - 1), 0, Th - 1.001)
        u0 = tu.astype(int)
        v0 = tv.astype(int)
        fu = tu - u0
        fv = tv - v0
        val = (
            pl.tex[v0, u0] * (1 - fu) * (1 - fv)
            + pl.tex[v0, u0 + 1] * fu * (1 - fv)
            + pl.tex[v0 + 1, u0] * (1 - fu) * fv
            + pl.tex[v0 + 1, u0 + 1] * fu * fv
        )
        img = np.where(closer, val, img)
        depth = np.where(closer, z, depth)
    depth = np.where(np.isfinite(depth), depth, 0.0)
    if return_depth:
        return img, depth
    return img


def orbit_trajectory(n_frames: int, radius=0.4, advance=0.02, yaw_rate=0.004):
    """Gentle forward + lateral sway camera path inside the room.

    Returns list of (4, 4) Tcw (camera looks down +z toward the back wall).
    """
    poses = []
    for i in range(n_frames):
        yaw = yaw_rate * i
        cx = radius * np.sin(0.15 * i)
        cz = -1.5 + advance * i
        cy = 0.1 * np.sin(0.07 * i)
        Rwc = np.array(
            [
                [np.cos(yaw), 0, np.sin(yaw)],
                [0, 1, 0],
                [-np.sin(yaw), 0, np.cos(yaw)],
            ],
            np.float32,
        )
        C = np.array([cx, cy, cz], np.float32)
        Tcw = np.eye(4, dtype=np.float32)
        Tcw[:3, :3] = Rwc.T
        Tcw[:3, 3] = -Rwc.T @ C
        poses.append(Tcw)
    return poses


def render_sequence(
    n_frames: int,
    K: np.ndarray,
    width=320,
    height=240,
    seed=0,
    with_depth=False,
    trajectory=None,
):
    planes = make_box_room(seed=seed)
    poses = trajectory or orbit_trajectory(n_frames)
    frames = []
    for Tcw in poses:
        out = render(planes, K, Tcw, width, height, return_depth=with_depth)
        frames.append(out)
    return frames, poses


def ba_window(K: int, M: int, O: int, seed: int = 0, fx: float = 520.0,
              cx: float = 320.0, cy: float = 240.0, bf: float = 52.0,
              outlier_frac: float = 0.1) -> list:
    """A seeded local bundle-adjustment window as the eight numpy arrays of
    ``ops.ba.BAProblem``: K cameras along a 2 m baseline, M points 5-10 m
    ahead, O observation slots per point (about 90% valid, a third stereo,
    octaves 0-3, 0.5 px noise), ``outlier_frac`` of the observations moved
    20-60 px, camera 0 fixed, and the start perturbed (1 cm on the other
    cameras, 2 cm on the points)."""
    rng = np.random.default_rng(seed)
    poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    poses[:, 0, 3] = np.linspace(0, 2, K)
    points = np.stack([rng.uniform(-3, 3, M), rng.uniform(-2, 2, M),
                       rng.uniform(5, 10, M)], 1).astype(np.float32)
    obs_kf = rng.integers(0, K, (M, O)).astype(np.int32)
    pc = points[:, None, :] + poses[obs_kf][..., :3, 3]
    u = fx * pc[..., 0] / pc[..., 2] + cx + rng.normal(0, 0.5, (M, O))
    v = fx * pc[..., 1] / pc[..., 2] + cy + rng.normal(0, 0.5, (M, O))
    ur = np.where(rng.random((M, O)) < 1 / 3, u - bf / pc[..., 2], -1.0)
    obs_uvr = np.stack([u, v, ur], -1).astype(np.float32)
    bad = rng.random((M, O)) < outlier_frac
    shift = rng.uniform(20, 60, (M, O, 2)) * rng.choice([-1, 1], (M, O, 2))
    obs_uvr[..., :2] += np.where(bad[..., None], shift, 0).astype(np.float32)
    obs_valid = rng.random((M, O)) < 0.9
    obs_kf[~obs_valid & (rng.random((M, O)) < 0.5)] = -1
    sigma2 = (1.2 ** (2.0 * rng.integers(0, 4, (M, O)))).astype(np.float32)
    poses_init = poses.copy()
    poses_init[1:, :3, 3] += rng.normal(0, 0.01, (K - 1, 3)).astype(np.float32)
    points_init = points + rng.normal(0, 0.02, points.shape).astype(np.float32)
    return [poses_init, np.arange(K) > 0, points_init, np.ones(M, bool), obs_kf,
            obs_uvr, sigma2, obs_valid]


def pose_graph_ring(K: int, seed: int = 0, fix_scale: bool = True):
    """A drifted Sim3 essential graph: K keyframes on a radius-5 ring, exact
    odometry edges (k, k - 1), one loop edge (0, K - 1) and a span-5 edge
    every 5th keyframe; the start integrated along the odometry with 0.01
    of noise per link (no scale noise with ``fix_scale``), keyframe 0
    fixed. Returns ((S_init, fixed, valid, edge_i, edge_j, edge_Sij,
    edge_valid), S_true) as torch tensors, the arguments of
    ``ops.pose_graph.optimize_pose_graph``."""
    import torch

    from ..ops import geometry as geo

    rng = np.random.default_rng(seed)
    a = 2 * np.pi * np.arange(K) / K
    zero, one = np.zeros_like(a), np.ones_like(a)
    Rwc = np.stack([np.stack([np.cos(a), zero, np.sin(a)], -1),
                    np.stack([zero, one, zero], -1),
                    np.stack([-np.sin(a), zero, np.cos(a)], -1)], 1)
    C = np.stack([5 * np.sin(a), zero, 5 * (1 - np.cos(a))], -1)
    Rcw = np.swapaxes(Rwc, 1, 2)
    t = -np.einsum("kij,kj->ki", Rcw, C)
    S_true = geo.sim3_make(torch.ones(K), torch.tensor(Rcw, dtype=torch.float32),
                           torch.tensor(t, dtype=torch.float32))
    ei = list(range(1, K)) + [0] + list(range(5, K, 5))
    ej = list(range(0, K - 1)) + [K - 1] + list(range(0, K - 5, 5))
    ei_t, ej_t = torch.tensor(ei), torch.tensor(ej)
    Sij = geo.sim3_compose(S_true[ei_t], geo.sim3_inverse(S_true[ej_t]))
    noise = torch.from_numpy(rng.normal(0, 0.01, (K, 7)).astype(np.float32))
    if fix_scale:
        noise[:, 6] = 0.0
    S = [S_true[0]]
    for k in range(K - 1):
        S.append(geo.sim3_compose(geo.sim3_exp(noise[k][None]),
                                  geo.sim3_compose(Sij[k][None], S[-1][None]))[0])
    fixed = torch.zeros(K, dtype=torch.bool)
    fixed[0] = True
    return (torch.stack(S), fixed, torch.ones(K, dtype=torch.bool),
            ei_t.to(torch.int32), ej_t.to(torch.int32), Sij,
            torch.ones(len(ei), dtype=torch.bool)), S_true


def _yaw_sim3(yaw, C):
    """(K, 8) Sim3 camera poses (scale 1) of cameras at centres C (K, 3)
    turned by ``yaw`` (K,) about the y axis."""
    from ..ops import sim3_np

    zero, one = np.zeros_like(yaw), np.ones_like(yaw)
    Rwc = np.stack([np.stack([np.cos(yaw), zero, np.sin(yaw)], -1),
                    np.stack([zero, one, zero], -1),
                    np.stack([-np.sin(yaw), zero, np.cos(yaw)], -1)], 1)
    Rcw = np.swapaxes(Rwc, 1, 2)
    return sim3_np.make(one, Rcw, -np.einsum("kij,kj->ki", Rcw, C)).astype(np.float32)


def corridor_pose(i: int) -> np.ndarray:
    """The 4x4 Tcw of keyframe i on a KITTI-like forward corridor: 0.8 m a
    keyframe along z, a gentle yaw (0.6 mrad a keyframe) and a 0.3 m sway
    (tests/test_capacity_scale.py's ``_corridor_pose``)."""
    yaw = 0.0006 * i
    R = np.array([[np.cos(yaw), 0, np.sin(yaw)],
                  [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]], np.float32)
    C = np.array([0.3 * np.sin(0.01 * i), 0.0, 0.8 * i], np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R.T
    T[:3, 3] = -R.T @ C
    return T


def integrate_drift(Sij_chain: np.ndarray, S0: np.ndarray, drift) -> np.ndarray:
    """Open-loop odometry with a drift per link: S[k+1] = exp(drift) Sij[k]
    S[k], S[0] = S0. ``Sij_chain`` (K-1, 8); returns (K, 8) float32."""
    import torch

    from ..ops import geometry as geo
    from ..ops import sim3_np

    Sd = geo.sim3_exp(torch.tensor(np.asarray(drift, np.float32))[None])[0].numpy()
    out = [np.asarray(S0, np.float32)]
    for Sij in Sij_chain:
        out.append(sim3_np.compose(Sd, sim3_np.compose(Sij, out[-1])))
    return np.stack(out).astype(np.float32)


def scale_graph(kind: str, K: int = 2000):
    """The 2000-vertex drifted essential graphs of the reference's scale
    tests, built with numpy:

    - "corridor": tests/test_capacity_scale.py::TestEssentialGraphScale, the
      corridor's odometry chain, the loop edge (0, K - 1) and a span-7
      covisibility edge every 15th keyframe, drift 0.004 m in z and 0.0004
      in log-scale a link;
    - "circle": tests/test_bow_posegraph.py::test_large_graph_cg, a radius-5
      circle, the loop edge and a span-5 edge every 10th keyframe, drift
      0.002 in x and 0.0005 in log-scale a link.

    Keyframe 0 is fixed. Returns ((S_init, fixed, valid, edge_i, edge_j,
    edge_Sij, edge_valid) as numpy arrays, the arguments of
    ``ops.pose_graph.optimize_pose_graph``, and S_true (K, 8))."""
    from ..ops import sim3_np

    i = np.arange(K, dtype=np.float32)
    drift = np.zeros(7, np.float32)
    if kind == "corridor":
        S_true = _yaw_sim3(0.0006 * i, np.stack(
            [0.3 * np.sin(0.01 * i), 0 * i, 0.8 * i], -1))
        extra = [(k + 7, k) for k in range(0, K - 10, 15)]
        drift[2], drift[6] = 0.004, 0.0004
    elif kind == "circle":
        a = 2 * np.pi * i / K
        S_true = _yaw_sim3(a, np.stack([5 * np.sin(a), 0 * a, 5 * (1 - np.cos(a))], -1))
        extra = [(k + 5, k) for k in range(0, K - 5, 10)]
        drift[0], drift[6] = 0.002, 0.0005
    else:
        raise ValueError(f"kind must be corridor or circle, got {kind!r}")
    ei = np.array(list(range(1, K)) + [0] + [e[0] for e in extra], np.int32)
    ej = np.array(list(range(0, K - 1)) + [K - 1] + [e[1] for e in extra], np.int32)
    Sij = sim3_np.compose(S_true[ei], sim3_np.inverse(S_true[ej])).astype(np.float32)
    S_init = integrate_drift(Sij[:K - 1], S_true[0], drift)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return (S_init, fixed, np.ones(K, bool), ei, ej, Sij,
            np.ones(len(ei), bool)), S_true


def corridor_map(m, n_kf: int, fx: float, fy: float, cx: float, cy: float,
                 p_new: int = 12, span: int = 4, depth=(3.0, 8.0),
                 seed: int = 7) -> list:
    """tests/test_capacity_scale.py::TestGbaSweep's map, built on ``m``
    through the MapState API (``add_keyframe``, ``add_map_points_batch``,
    ``add_observations_batch``, ``update_connections``; the port's MapState
    or the reference's): ``n_kf`` keyframes on ``corridor_pose``, each
    stored under an independent local warp W centred at its camera (2 mrad
    of rotation, 2 cm of translation; none for keyframe 0), so the stored
    pose is T_true W^-1. Each keyframe makes ``p_new`` points ahead of it
    (x in +-2 m, y in +-1.5 m, ``depth`` in z; a depth range past the
    corridor's 0.8 m a keyframe times ``span`` keeps every observer in
    front), stored under its warp; each point is seen by ``span``
    consecutive keyframes, its measurements the true points projected
    through the true poses with (fx, fy, cx, cy): exact, the error lives
    in the stored state only. Returns the keyframe ids in creation order."""
    import torch

    from ..ops import geometry as geo

    rng = np.random.default_rng(seed)
    NF = m.kf_xy.shape[1]
    pend_ids = np.empty(0, np.int64)
    pend_pw = np.empty((0, 3), np.float32)
    pend_left = np.empty(0, np.int64)
    kf_ids = []
    for i in range(n_kf):
        Tt = corridor_pose(i)
        Twc = np.linalg.inv(Tt)
        W = np.eye(4, dtype=np.float32)
        if i > 0:
            W[:3, :3] = geo.so3_exp(
                torch.tensor(rng.normal(0, 0.002, 3), dtype=torch.float32)).numpy()
            C = Twc[:3, 3]
            W[:3, 3] = C - W[:3, :3] @ C + rng.normal(0, 0.02, 3)
        Td = (Tt @ np.linalg.inv(W)).astype(np.float32)
        pc = np.stack([rng.uniform(-2, 2, p_new), rng.uniform(-1.5, 1.5, p_new),
                       rng.uniform(depth[0], depth[1], p_new)], 1).astype(np.float32)
        pw_true = pc @ Twc[:3, :3].T + Twc[:3, 3]
        obs_pw = np.concatenate([pw_true, pend_pw])[:NF]
        n_obs = len(obs_pw)
        pci = obs_pw @ Tt[:3, :3].T + Tt[:3, 3]
        xy = np.zeros((NF, 2), np.float32)
        xy[:n_obs, 0] = fx * pci[:, 0] / pci[:, 2] + cx
        xy[:n_obs, 1] = fy * pci[:, 1] / pci[:, 2] + cy
        valid = np.zeros(NF, bool)
        valid[:n_obs] = True
        kf = m.add_keyframe(Td, xy, rng.integers(0, 256, (NF, 32), dtype=np.uint8),
                            np.zeros(NF, np.int32), np.zeros(NF, np.float32),
                            valid, i, i / 30.0)
        kf_ids.append(kf)
        n_fresh = min(p_new, n_obs)
        pw_stored = pw_true[:n_fresh] @ W[:3, :3].T + W[:3, 3]
        new_ids = m.add_map_points_batch(pw_stored.astype(np.float32), kf)
        m.add_observations_batch(np.concatenate([new_ids, pend_ids])[:n_obs], kf,
                                 np.arange(n_obs))
        m.update_connections(kf)
        keep = pend_left > 1
        pend_ids = np.concatenate([new_ids, pend_ids[keep]])
        pend_pw = np.concatenate([pw_true[:n_fresh], pend_pw[keep]])
        pend_left = np.concatenate([np.full(n_fresh, span - 1), pend_left[keep] - 1])
    return kf_ids
