"""Parity of the port's bag of words (``orbslam2_tpu_torch/ops/bow.py``,
kernel Y's plain version) with the JAX package's ``ops/bow.py``: the
vocabulary asset, the word of every descriptor (exact), the TF-IDF vector
(within 1e-6 relative) and the L1 score."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.ops import bow as jbow
from orbslam2_tpu_torch.kernels import bow_words
from orbslam2_tpu_torch.ops import bow as tbow

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_vocabulary_asset_is_the_reference_copy():
    with open(os.path.join(REPO, "orbslam2_tpu", "assets", "vocabulary.npz"), "rb") as f:
        ref = f.read()
    with open(tbow.VOCAB_PATH, "rb") as f:
        assert f.read() == ref
    bits, idf = tbow.default_vocabulary()
    jbits, jidf = jbow.default_vocabulary()
    np.testing.assert_array_equal(bits, jbits)
    np.testing.assert_array_equal(idf, jidf)
    np.testing.assert_array_equal(tbow.random_vocabulary(64), jbow.random_vocabulary(64))


def _descriptors(rng, vocab_bits, n=500):
    """n packed descriptors: a third near copies of vocabulary words (a few
    bits flipped), the rest random; ~10% invalid rows."""
    desc = rng.integers(0, 256, (n, 32)).astype(np.uint8)
    near = rng.choice(vocab_bits.shape[0], n // 3, replace=False)
    bits = vocab_bits[near].copy()
    flip = rng.random(bits.shape) < 0.02
    bits[flip] ^= 1
    desc[: n // 3] = np.packbits(bits, axis=1, bitorder="little")
    valid = rng.random(n) > 0.1
    return desc, valid


@pytest.mark.parametrize("case", ["asset_idf", "ties_no_idf"])
def test_bow_vector_matches_reference(case):
    """Words exact against the reference's assignment (argmin, the first word
    on ties); the vector within 1e-6 relative of the reference's
    ``bow_vector``. ``ties_no_idf``: a random 4096-word vocabulary whose
    second half repeats the first, so every nearest word is tied."""
    rng = np.random.default_rng(3)
    if case == "asset_idf":
        vocab_bits, idf = jbow.default_vocabulary()
    else:
        half = rng.integers(0, 2, (2048, 256)).astype(np.uint8)
        vocab_bits, idf = np.concatenate([half, half]), None
    desc, valid = _descriptors(rng, vocab_bits)

    words, vec = bow_words.bow_words(
        torch.from_numpy(desc), torch.from_numpy(valid),
        torch.from_numpy(tbow.pack_vocabulary(vocab_bits)),
        None if idf is None else torch.from_numpy(idf))
    ref_words = jbow.assign_words(
        np.unpackbits(desc[valid], axis=1, bitorder="little").astype(np.float32),
        vocab_bits.astype(np.float32))
    np.testing.assert_array_equal(words.numpy()[valid], ref_words)
    assert (words.numpy()[~valid] == -1).all()
    if case == "ties_no_idf":
        assert (ref_words < 2048).all()
    ref_vec = np.asarray(jbow.bow_vector(
        jnp.asarray(desc), jnp.asarray(valid), jnp.asarray(vocab_bits),
        None if idf is None else jnp.asarray(idf)))
    np.testing.assert_allclose(vec.numpy(), ref_vec, rtol=1e-6, atol=0)
    assert abs(float(vec.sum()) - 1.0) < 1e-5


def test_l1_score():
    rng = np.random.default_rng(4)
    a = rng.random(4096).astype(np.float32) * (rng.random(4096) < 0.05)
    b = rng.random((3, 4096)).astype(np.float32) * (rng.random((3, 4096)) < 0.05)
    a /= a.sum()
    b /= b.sum(-1, keepdims=True)
    ref = np.asarray(jbow.l1_score(jnp.asarray(a), jnp.asarray(b)))
    out = tbow.l1_score(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
