"""Parity of the port's ORB extraction (kernels A and B through their plain
versions on the CPU) against the JAX package's, on rendered and random
frames at 320x240, 500 features, 4 levels."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from orbslam2_tpu.config import ExtractorConfig as JExtractorConfig
from orbslam2_tpu.ops import orb as jorb
from orbslam2_tpu_torch.config import ExtractorConfig
from orbslam2_tpu_torch.kernels import describe as tdescribe
from orbslam2_tpu_torch.kernels import fast_score as tfast
from orbslam2_tpu_torch.ops import orb as torb
from orbslam2_tpu_torch.utils.convert import brief_pattern
from orbslam2_tpu_torch.utils.synthetic import render_sequence

torch.set_num_threads(2)

W, H = 320, 240
K = np.array([[260.0, 0, 160], [0, 260, 120], [0, 0, 1]], np.float32)
# subpixel keypoint coordinates above level 0 come from float32 scores that
# differ in the last bits; 1e-3 px is far below every matching gate
XY_TOL = 1e-3


@functools.lru_cache()
def _frames():
    rendered, _ = render_sequence(8, K, width=W, height=H)
    rng = np.random.default_rng(0)
    noise = [rng.integers(0, 256, (H, W)).astype(np.float32) for _ in range(2)]
    return [f.astype(np.float32) for f in rendered[::4]] + noise


@functools.lru_cache()
def _extract(i):
    img = _frames()[i]
    fj = jorb.OrbExtractor(JExtractorConfig(n_features=500, n_levels=4), H, W)(img)
    ft = torb.OrbExtractor(ExtractorConfig(n_features=500, n_levels=4), H, W,
                           device="cpu")(img)
    fj = {k: np.asarray(getattr(fj, k)) for k in fj._fields}
    ft = {k: getattr(ft, k).numpy() for k in ft._fields}
    return fj, ft


def _bits(desc):
    return np.unpackbits(desc, axis=-1)


def test_asset_and_budgets():
    pa, pb = brief_pattern()
    jpa, jpb = jorb._brief_pattern()
    np.testing.assert_array_equal(pa, jpa)
    np.testing.assert_array_equal(pb, jpb)
    for args in [(500, 4, 1.2), (1000, 8, 1.2), (2000, 8, 1.2)]:
        assert torb.level_budgets(*args) == jorb.level_budgets(*args)
    np.testing.assert_array_equal(tfast.FAST_RING, jorb.FAST_RING)


@pytest.mark.parametrize("i", [0, 2])
def test_fast_score_nms_matches_reference(i):
    """Kernel A's plain version is bit-exact against the reference's
    fast_score_map + border mask + 3x3 NMS."""
    img = _frames()[i]
    S_raw_j = np.asarray(jorb.fast_score_map(jnp.asarray(img)))
    S_raw_t, S_t = tfast.fast_score_nms_plain(torch.from_numpy(img), torb.PATCH_R)
    np.testing.assert_array_equal(S_raw_t.numpy(), S_raw_j)
    ys, xs = np.mgrid[:H, :W]
    b = torb.PATCH_R
    inside = (ys >= b) & (ys < H - b) & (xs >= b) & (xs < W - b)
    S = np.where(inside, S_raw_j, -1.0)
    Sp = np.pad(S, 1, constant_values=-np.inf)
    pooled = np.max([Sp[dy:dy + H, dx:dx + W] for dy in range(3) for dx in range(3)], 0)
    np.testing.assert_array_equal(S_t.numpy(), np.where(S >= pooled, S, -1.0))


@pytest.mark.parametrize("i", [0, 1, 2, 3])
def test_detect_level0_bit_exact(i):
    """Level 0 is an integer image: detection is bit-exact, subpixel
    offsets included (same single float32 ops)."""
    img = _frames()[i]
    out_j = jorb.detect_level(jnp.asarray(img), 209, 20.0, 7.0)
    out_t = torb.detect_level(torch.from_numpy(img), 209, 20.0, 7.0)
    for a, b in zip(out_j, out_t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("i", [0, 1, 2, 3])
def test_features_parity(i):
    fj, ft = _extract(i)
    budgets = jorb.level_budgets(500, 4, 1.2)
    starts = np.cumsum([0] + budgets)
    # level 0: the FAST score is single float32 subtractions of the input
    # image, so xy, octave and valid are bit-exact
    s0, e0 = starts[0], starts[1]
    np.testing.assert_array_equal(ft["valid"][s0:e0], fj["valid"][s0:e0])
    np.testing.assert_array_equal(ft["octave"], fj["octave"])
    v0 = fj["valid"][s0:e0]
    np.testing.assert_array_equal(ft["xy"][s0:e0][v0], fj["xy"][s0:e0][v0])
    # levels >= 1: the resized levels differ by float32 rounding of the
    # resize products, so a score at a threshold or tie can flip, and the
    # subpixel offsets carry that rounding (XY_TOL); at least 99% of the
    # reference's keypoints above level 0 are found identically
    found = total = 0
    for lvl in range(1, len(budgets)):
        s, e = starts[lvl], starts[lvl + 1]
        kj = fj["xy"][s:e][fj["valid"][s:e]]
        kt = ft["xy"][s:e][ft["valid"][s:e]]
        d = np.abs(kj[:, None, :] - kt[None, :, :]).max(-1)
        found += int((d.min(1) <= XY_TOL).sum())
        total += len(kj)
    assert found >= 0.99 * total, (found, total)


@pytest.mark.parametrize("i", [0, 1, 2, 3])
def test_angles_and_descriptors(i):
    fj, ft = _extract(i)
    # keypoints found identically (same slot, octave, and coords up to the
    # rounding of the subpixel offset)
    same = fj["valid"] & ft["valid"] & np.all(
        np.abs(fj["xy"] - ft["xy"]) <= XY_TOL, 1)
    assert same.sum() >= 0.99 * fj["valid"].sum()
    # angles: the port sums the moments directly, the reference through
    # whole-row prefix sums whose float32 rounding reaches ~2e-3 rad on
    # weak-gradient patches (test_ic_angle_accuracy measures both against
    # float64). So 99% agree within 1e-3 rad and none is off by more than
    # the reference's own rounding
    d = np.abs(ft["angle"][same] - fj["angle"][same])
    d = np.minimum(d, 2 * np.pi - d)
    assert (d <= 1e-3).mean() >= 0.99, np.sort(d)[-5:]
    assert d.max() < 5e-3, d.max()
    # descriptors: a bit flips only where a rotated test offset lands on a
    # rounding boundary
    agree = (_bits(ft["desc"][same]) == _bits(fj["desc"][same])).mean()
    assert agree >= 0.995, agree


def test_describe_kernel_plain_matches_reference_functions():
    """Kernel B's plain version against the reference's ic_angles_conv and
    brief_descriptors_flat on an integer-valued level-0 image (the random
    frame) and its keypoints."""
    img = _frames()[2]
    xy, _, _, valid = jorb.detect_level(jnp.asarray(img), 209, 20.0, 7.0)
    from orbslam2_tpu.ops import image as jimg

    blurred = jimg.gaussian_blur(jnp.asarray(img))
    ang_j = np.asarray(jorb.ic_angles_conv(jnp.asarray(img), xy))
    desc_j = np.asarray(jorb.brief_descriptors_flat(blurred, xy, jnp.asarray(ang_j)))
    ang_t, desc_t = tdescribe.orb_describe_plain(
        torch.from_numpy(img), torch.from_numpy(np.array(blurred)),
        torch.from_numpy(np.asarray(xy)))
    v = np.asarray(valid)
    # integer image: the moments are exact in both, so the angles agree to
    # atan2's last ulp and the descriptors agree bit for bit
    np.testing.assert_allclose(ang_t.numpy()[v], ang_j[v], atol=1e-6)
    agree = (_bits(desc_t.numpy()[v]) == _bits(desc_j[v])).mean()
    assert agree >= 0.999, agree


def test_upright_descriptors():
    img = _frames()[0]
    cfgj = JExtractorConfig(n_features=500, n_levels=4, upright=True)
    cfgt = ExtractorConfig(n_features=500, n_levels=4, upright=True)
    fj = jorb.OrbExtractor(cfgj, H, W)(img)
    ft = torb.OrbExtractor(cfgt, H, W, device="cpu")(img)
    s = slice(0, jorb.level_budgets(500, 4, 1.2)[0])
    v = np.asarray(fj.valid)[s]
    # upright: no rotation, so level-0 descriptors are bit-exact
    np.testing.assert_array_equal(ft.desc.numpy()[s][v], np.asarray(fj.desc)[s][v])


@pytest.mark.parametrize("i", [0, 2])
def test_ic_angle_accuracy(i):
    """The port's direct-sum angle against the same sum in float64 on every
    level: within 1e-4 rad, while the reference's prefix-sum angle is
    allowed its own measured rounding (below 5e-3 rad)."""
    from orbslam2_tpu_torch.ops import image as timg

    levels = timg.build_pyramid(torch.from_numpy(_frames()[i]), 4, 1.2)
    for L in levels:
        xy, _, _, v = torb.detect_level(L, 150, 20.0, 7.0)
        a32, _ = tdescribe.orb_describe_plain(L, L, xy)
        a64, _ = tdescribe.orb_describe_plain(L.double(), L.double(), xy)
        aj = np.asarray(jorb.ic_angles_conv(jnp.asarray(L.numpy()),
                                            jnp.asarray(xy.numpy())))
        v = v.numpy()

        def err(a):
            d = np.abs(a - a64.numpy())
            return np.minimum(d, 2 * np.pi - d)[v].max()

        assert err(a32.numpy()) < 1e-4
        assert err(aj) < 5e-3
