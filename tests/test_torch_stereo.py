"""Parity of the port's stereo matcher against the JAX package on the CPU:
``stereo_match`` (kernel V's plain version) and ``subpixel_refine`` (kernel
W's plain version) on a rendered 320x240 stereo pair quantized to 8 bits,
as a camera delivers it: u_right and depth bit-exact (the SADs of integer
grey levels are exact in any summation order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from orbslam2_tpu.ops import orb as jorb
from orbslam2_tpu.ops import stereo as jstereo
from orbslam2_tpu_torch.config import ExtractorConfig
from orbslam2_tpu_torch.kernels import stereo_match as tstereo_match
from orbslam2_tpu_torch.kernels import stereo_sad as tstereo_sad
from orbslam2_tpu_torch.ops import orb as torb
from orbslam2_tpu_torch.ops import stereo as tstereo
from orbslam2_tpu_torch.utils.synthetic import make_box_room, orbit_trajectory, render

torch.set_num_threads(2)

K = np.array([[260.0, 0, 160], [0, 260, 120], [0, 0, 1]], np.float32)
W, H = 320, 240
BF = 52.0
SCALES = np.asarray(ExtractorConfig(n_features=500, n_levels=4).scale_factors, np.float32)


@pytest.fixture(scope="module")
def pair():
    """A rendered left/right pair (baseline bf/fx = 0.2 m) and the port's
    features of both images."""
    planes = make_box_room(seed=0)
    Tcw = orbit_trajectory(3)[2]
    Trl = np.eye(4, dtype=np.float32)
    Trl[0, 3] = -BF / K[0, 0]
    left, right = (np.clip(np.rint(render(planes, K, T, W, H)), 0, 255).astype(np.uint8)
                   for T in (Tcw, Trl @ Tcw))
    ext = torb.OrbExtractor(ExtractorConfig(n_features=500, n_levels=4), H, W,
                            device="cpu")
    return left, right, ext(left), ext(right)


def _jfeat(f):
    return jorb.Features(*(jnp.asarray(x.numpy()) for x in f))


def test_stereo_match_bit_exact(pair):
    left, right, fl, fr = pair
    md = np.float32(BF / K[0, 0])
    ur_j, d_j = jstereo.stereo_match(_jfeat(fl), _jfeat(fr), jnp.float32(BF),
                                     jnp.float32(md), jnp.asarray(SCALES))
    ur_t, d_t = tstereo.stereo_match(fl, fr, BF, float(md), torch.from_numpy(SCALES))
    np.testing.assert_array_equal(ur_t.numpy(), np.asarray(ur_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    assert (d_t > 0).sum() > 100


def test_subpixel_refine_bit_exact(pair):
    left, right, fl, fr = pair
    md = np.float32(BF / K[0, 0])
    ur0, d0 = tstereo_match.stereo_match_plain(
        fl.xy, fl.octave, fl.desc, fl.valid, fr.xy, fr.octave, fr.desc, fr.valid,
        torch.from_numpy(SCALES), BF, float(md))
    ur_j, d_j = jstereo.subpixel_refine(
        jnp.asarray(left, jnp.float32), jnp.asarray(right, jnp.float32),
        jnp.asarray(fl.xy.numpy()), jnp.asarray(ur0.numpy()),
        jnp.asarray(d0.numpy() > 0), jnp.float32(BF))
    lt = torch.from_numpy(left.astype(np.float32))
    rt = torch.from_numpy(right.astype(np.float32))
    ur_t, d_t = tstereo_sad.stereo_sad(lt, rt, fl.xy, ur0, d0, BF)
    np.testing.assert_array_equal(ur_t.numpy(), np.asarray(ur_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    refined = (d_t > 0) & (ur_t != ur0)
    assert refined.sum() > 100   # the parabola moved most matches
