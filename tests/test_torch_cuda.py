"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``; each test skips where there is no CUDA device (the decision
is made in the fixture, so every worker collects the same tests). On a
machine with an H100 and nvcc, which has no JAX (hence no conftest, whose
CPU-mesh setup imports it) and no xdist (hence no addopts):

    python -m pytest tests/test_torch_cuda.py -q --noconftest -o addopts= -m cuda
"""

import numpy as np
import pytest
import torch

from orbslam2_tpu_torch import kernels
from orbslam2_tpu_torch.config import CameraConfig, ExtractorConfig, SlamConfig
from orbslam2_tpu_torch.kernels import (ba_accept, ba_linearize, ba_solve,
                                        ba_update_cost, describe, fast_score,
                                        hamming, pose_lm)
from orbslam2_tpu_torch.models.camera import Camera
from orbslam2_tpu_torch.ops import ba
from orbslam2_tpu_torch.ops import image as img_ops
from orbslam2_tpu_torch.ops import orb
from orbslam2_tpu_torch.utils import ba_parity
from orbslam2_tpu_torch.utils.synthetic import ba_window, render_sequence

pytestmark = pytest.mark.cuda

W, H = 320, 240
K = np.array([[260.0, 0, 160], [0, 260, 120], [0, 0, 1]], np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU build)")
    return torch.device("cuda")


def _frame(dev):
    frames, _ = render_sequence(1, K, width=W, height=H)
    return torch.from_numpy(frames[0].astype(np.float32)).to(dev)


def test_fast_score_nms_bit_exact(cuda):
    img = _frame(cuda)
    for border in (20, 3):
        a = fast_score.fast_score_nms(img, border)
        b = fast_score.fast_score_nms_plain(img, border)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_select_level_matches_cpu(cuda):
    """The plain selection (stable sorts) picks the same keypoints on the
    card as on the CPU."""
    img = _frame(cuda)
    raw, nms = fast_score.fast_score_nms(img, orb.PATCH_R)
    out_gpu = orb.select_level(raw, nms, 200, 20.0, 7.0)
    out_cpu = orb.select_level(raw.cpu(), nms.cpu(), 200, 20.0, 7.0)
    for a, b in zip(out_gpu, out_cpu):
        assert torch.equal(a.cpu(), b)


def test_orb_describe(cuda):
    img = _frame(cuda)
    raw, nms = fast_score.fast_score_nms(img, orb.PATCH_R)
    xy, _, _, v = orb.select_level(raw, nms, 200, 20.0, 7.0)
    blurred = img_ops.gaussian_blur(img)
    for upright in (False, True):
        ak, dk = describe.orb_describe(img, blurred, xy, upright)
        ap, dp = describe.orb_describe_plain(img, blurred, xy, upright)
        d = (ak - ap).abs()
        assert torch.minimum(d, 2 * np.pi - d)[v].max() < 1e-3
        bits = lambda x: np.unpackbits(x[v].cpu().numpy(), axis=1)  # noqa: E731
        assert (bits(dk) == bits(dp)).mean() >= 0.995


def test_hamming_top2_gated_bit_exact(cuda):
    rng = np.random.default_rng(31)
    P, N = 3000, 512
    kp_desc = rng.integers(0, 256, (N, 32)).astype(np.uint8)
    mp_desc = rng.integers(0, 256, (P, 32)).astype(np.uint8)
    mp_desc[:N] = kp_desc ^ (rng.integers(0, 256, (N, 32)) & rng.integers(0, 256, (N, 32))
                             & rng.integers(0, 256, (N, 32))).astype(np.uint8)
    kp_xy = np.stack([rng.uniform(0, W, N), rng.uniform(0, H, N)], 1).astype(np.float32)
    proj = np.concatenate([kp_xy + rng.normal(0, 3, (N, 2)),
                           rng.uniform(0, W, (P - N, 2))]).astype(np.float32)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(cuda)  # noqa: E731
    args = (t(mp_desc), t(proj), t(rng.uniform(4, 30, P).astype(np.float32)),
            t(rng.integers(0, 4, P).astype(np.int32)),
            t((proj[:, 0] - 5 + rng.normal(0, 4, P)).astype(np.float32)),
            t(rng.random(P) < 0.8), t(kp_desc), t(kp_xy),
            t(rng.integers(0, 4, N).astype(np.int32)), t(rng.random(N) < 0.95),
            t(np.where(rng.random(N) < 0.5, kp_xy[:, 0] - 5, -1).astype(np.float32)))
    for a, b in zip(hamming.hamming_top2_gated(*args),
                    hamming.hamming_top2_gated_plain(*args)):
        assert torch.equal(a, b)


def test_pose_lm_matches_plain(cuda):
    rng = np.random.default_rng(32)
    n = 4096
    pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                    rng.uniform(2, 8, n)], 1).astype(np.float32)
    pc = pts + np.float32([0.05, -0.02, 0.1])
    u = 260 * pc[:, 0] / pc[:, 2] + 160 + rng.normal(0, 0.7, n)
    v = 260 * pc[:, 1] / pc[:, 2] + 120 + rng.normal(0, 0.7, n)
    ur = np.where(rng.random(n) < 0.5, u - 26.0 / pc[:, 2], -1.0)
    obs = np.stack([u, v, ur], 1).astype(np.float32)
    obs[rng.random(n) < 0.1, :2] += 30.0
    valid = rng.random(n) < 0.15
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(cuda)  # noqa: E731
    cam = Camera.create(260.0, 260.0, 160.0, 120.0, bf=26.0, width=W, height=H)
    args = (t(np.eye(4, dtype=np.float32)), cam, t(pts), t(obs),
            t((1.2 ** (2.0 * rng.integers(0, 4, n))).astype(np.float32)), t(valid))
    Tk, ik, nk, _ = pose_lm.pose_lm(*args)
    Tp, ip, npl, _ = pose_lm.pose_lm_plain(*args)
    # block reduction order differs from the plain sums: 1e-4, and inlier
    # counts within 0.5% of the valid edges
    assert (Tk - Tp).abs().max().item() <= 1e-4
    assert abs(int(nk) - int(npl)) <= 0.005 * valid.sum()


# the two BA shapes of chip_smoke.py: the local-BA window and the
# reference bench's, with the iterations each runs there
BA_SHAPES = [(16, 1024, 5), (64, 4096, 10)]
BA_CAM = Camera.create(520.0, 520.0, 320.0, 240.0, bf=52.0)


def _ba_problem(dev, K, M):
    return ba.BAProblem(*(torch.from_numpy(a).to(dev)
                          for a in ba_window(K, M, 8, seed=K)))


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def _point_rel(a, b):
    """Largest point difference relative to the point's distance."""
    return ((a - b).norm(dim=1) / b.norm(dim=1).clamp_min(1e-6)).max().item()


@pytest.mark.parametrize("K,M,iters", BA_SHAPES)
def test_ba_steps_match_plain(cuda, K, M, iters):
    """One LM iteration, kernel by kernel (E, F, G, H), each fed the same
    inputs as its plain version. S is a float-atomic sum and the other sums
    run in another order: 1e-4 of each output's largest entry for E, 1e-4
    on the trial poses, 1e-4 of each point's distance, 1e-4 relative on
    the cost, 0.1%
    inlier flips; H only selects and scales, so it is exact."""
    prob = _ba_problem(cuda, K, M)
    lam = torch.full((1,), 1e-4, device=cuda)
    obs = (prob.point_valid, prob.obs_kf, prob.obs_uvr, prob.obs_sigma2)
    e_args = (BA_CAM, prob.poses, prob.points, *obs, prob.obs_valid, lam, True)
    lin = ba_linearize.ba_linearize(*e_args)
    for a, b in zip(lin, ba_linearize.ba_linearize_plain(*e_args)):
        assert _rel(a, b) <= 1e-4
    f_args = (lin.S, lin.b_S, prob.opt_mask, lam, prob.poses)
    dc, poses_n = ba_solve.ba_solve(*f_args)
    assert (poses_n - ba_solve.ba_solve_plain(*f_args)[1]).abs().max() <= 1e-4
    g_args = (BA_CAM, poses_n, prob.points, *obs, prob.obs_valid,
              prob.obs_valid, True, (dc, lin.E, lin.Dinv, lin.b_l))
    pk, ck, ik = ba_update_cost.ba_update_cost(*g_args)
    pp, cp, ip = ba_update_cost.ba_update_cost_plain(*g_args)
    assert _point_rel(pk, pp) <= 1e-4
    assert abs(ck.item() - cp.item()) <= 1e-4 * abs(cp.item())
    assert (ik != ip).float().mean() <= 1e-3
    for cost in (1e9, 0.0):   # accepted, rejected
        states = [(ck, poses_n, pk, torch.full((1,), cost, device=cuda),
                   lam.clone(), prob.poses.clone(), prob.points.clone())
                  for _ in range(2)]
        ba_accept.ba_accept(*states[0])
        ba_accept.ba_accept_plain(*states[1])
        for a, b in zip(states[0][3:], states[1][3:]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("K,M,iters", BA_SHAPES)
def test_optimize_ba_matches_plain(cuda, K, M, iters):
    """The whole schedule through kernels E-H against the plain schedule on
    the card, held to ``ba_parity.LIMITS`` (float atomics in S): poses
    1e-4, points 1e-4 of their distance where the final inliers constrain
    them and every point's reprojections within 1e-2 px, 0.1% inlier
    flips, cost 1e-3 relative."""
    prob = _ba_problem(cuda, K, M)
    kernels.reset_launches()
    rk = ba.optimize_ba(BA_CAM, prob, iters=iters, outlier_rounds=1)
    counts = kernels.launch_counts()
    rp = ba.optimize_ba_plain(BA_CAM, prob, iters=iters, outlier_rounds=1)
    assert ba_parity.over_limits(ba_parity.compare(BA_CAM, prob, rk, rp)) == {}
    # each LM iteration launches E, F and H once and G twice; G also gives
    # each phase's initial cost, the outlier classification and the final one
    n_lm = iters + max(iters // 2, 1)
    n_phases = len(ba._split(iters)) + len(ba._split(max(iters // 2, 1)))
    assert counts["ba_linearize"] == counts["ba_solve"] == counts["ba_accept"] == n_lm
    assert counts["ba_update_cost"] == n_lm + n_phases + 2


def test_ba_kernels_refuse_oversize(cuda):
    """Above K = 64, M = 4096 or O = 8 the kernels raise, they do not fall
    back."""
    big = _ba_problem(cuda, 16, 4097)
    with pytest.raises(ValueError, match="M <= 4096"):
        ba.optimize_ba(BA_CAM, big, iters=1)


def test_slice_runs_through_kernels(cuda):
    from orbslam2_tpu_torch.system import SlamSystem

    frames, _ = render_sequence(12, K, width=W, height=H, with_depth=True)
    cfg = SlamConfig(sensor="rgbd",
                     camera=CameraConfig(fx=260, fy=260, cx=160, cy=120, width=W,
                                         height=H, bf=26.0, fps=30),
                     extractor=ExtractorConfig(n_features=500, n_levels=4))
    slam = SlamSystem(cfg, device=cuda)
    kernels.reset_launches()
    for i, (img, depth) in enumerate(frames):
        assert slam.track_rgbd(img, depth, i / 30.0) is not None
    assert all(n > 0 for n in kernels.launch_counts().values())
