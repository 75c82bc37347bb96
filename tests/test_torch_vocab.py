"""Vocabulary training in the port (ops/bow.py trainers on kernels Y and Y'
as their plain versions) against the JAX package's trainers, and
vocabularies carried between the two packages."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from orbslam2_tpu.ops import bow as jbow
from orbslam2_tpu_torch.kernels import vocab_update as tvu
from orbslam2_tpu_torch.ops import bow as tbow

torch.set_num_threads(2)


def _clustered(n=3000, n_seeds=64, flip=0.08, seed=3):
    """Packed (n, 32) descriptors around ``n_seeds`` random 256-bit seeds,
    each bit flipped with probability ``flip``."""
    rng = np.random.default_rng(seed)
    seeds = rng.integers(0, 2, (n_seeds, 256)).astype(np.uint8)
    bits = seeds[rng.integers(0, n_seeds, n)]
    bits = bits ^ (rng.random((n, 256)) < flip).astype(np.uint8)
    return np.packbits(bits, axis=1, bitorder="little"), bits


@pytest.fixture(scope="module")
def corpus():
    return _clustered()


def test_train_vocabulary_device_matches_jax(corpus):
    desc, _ = corpus
    ref = jbow.train_vocabulary_jax(desc, n_words=256, iters=3, seed=7, chunk=1024)
    got = tbow.train_vocabulary_device(desc, n_words=256, iters=3, seed=7,
                                       device="cpu")
    assert got.dtype == np.uint8 and got.shape == (256, 256)
    np.testing.assert_array_equal(got, ref)
    # the k-means moved the start: trained, not the sampled rows
    start = np.unpackbits(desc[np.random.default_rng(7).choice(3000, 256, replace=False)],
                          axis=1, bitorder="little")
    assert (got != start).any()


def test_train_vocabulary_padded_matches_numpy(corpus):
    """Fewer descriptors than words: the numpy trainer trains the
    random-padded vocabulary, the device trainer returns it untrained."""
    desc = corpus[0][:200]
    ref = jbow.train_vocabulary(desc, n_words=256, iters=3, seed=7)
    got = tbow.train_vocabulary(desc, n_words=256, iters=3, seed=7, device="cpu")
    np.testing.assert_array_equal(got, ref)
    untrained = tbow.train_vocabulary_device(desc, n_words=256, iters=3, seed=7,
                                             device="cpu")
    np.testing.assert_array_equal(
        untrained, jbow.train_vocabulary_jax(desc, n_words=256, iters=3, seed=7))


def test_compute_idf_matches_both_reference_paths(corpus):
    desc, _ = corpus
    rng = np.random.default_rng(5)
    valid = rng.random(len(desc)) < 0.9
    docs = np.sort(rng.integers(0, 40, len(desc)))
    vocab = tbow.train_vocabulary_device(desc, n_words=256, iters=2, seed=7,
                                         device="cpu")
    got = tbow.compute_idf(desc, valid, docs, vocab, device="cpu")
    for use_jax in (False, True):
        ref = jbow.compute_idf(desc, valid, docs, vocab, use_jax=use_jax)
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    bits = np.unpackbits(desc[:500], axis=1, bitorder="little")
    np.testing.assert_array_equal(
        tbow.assign_words(bits, vocab, device="cpu"),
        jbow.assign_words(bits.astype(np.float32), vocab.astype(np.float32)))


def test_vote_tie_and_empty_word():
    """2 * sum == count gives 0 (the reference's float32 sum / count > 0.5
    is false at exactly 0.5); a word with no descriptor keeps its centre;
    a strict majority sets the bit."""
    rng = np.random.default_rng(9)
    bits = np.zeros((6, 256), np.uint8)
    bits[0, :3] = 1          # word 0: bits 0-2 set in 1 of 2 rows (tie),
    bits[1, 0] = 1           # bit 0 in both rows (majority)
    bits[2:5, 7] = 1         # word 1: bit 7 in 3 of 4 rows, bit 8 in 2 of 4
    bits[2:4, 8] = 1
    words = torch.tensor([0, 0, 1, 1, 1, 1], dtype=torch.int32)
    old = rng.integers(0, 256, (3, 32)).astype(np.uint8)
    desc = torch.from_numpy(np.packbits(bits, axis=1, bitorder="little"))
    counts, sums, new = tvu.vocab_update(desc, words, torch.from_numpy(old))
    assert counts.tolist() == [2, 4, 0]
    assert sums[0, :3].tolist() == [2, 1, 1] and sums[1, 7:9].tolist() == [3, 2]
    nb = np.unpackbits(new.numpy(), axis=1, bitorder="little")
    assert nb[0].tolist() == [1] + [0] * 255
    assert nb[1].tolist() == [0] * 7 + [1] + [0] * 248
    np.testing.assert_array_equal(new.numpy()[2], old[2])
    # the same rule as the reference's float32 update on these rows
    s = np.zeros((4, 256), np.float32)
    np.add.at(s, words.numpy(), bits.astype(np.float32))
    c = np.bincount(words.numpy(), minlength=4).astype(np.float32)
    ref = s[:3] / np.maximum(c[:3, None], 1.0) > 0.5
    np.testing.assert_array_equal(nb[:2], ref[:2].astype(np.uint8))


def test_vocabularies_cross_load(corpus, tmp_path):
    """A vocabulary either package trains loads unchanged in the other and
    gives the same BoW vectors there."""
    desc, _ = corpus
    docs = np.arange(len(desc)) // 75
    valid = np.ones(len(desc), bool)
    port_bits = tbow.train_vocabulary_device(desc, n_words=256, iters=2, seed=11,
                                             device="cpu")
    port_idf = tbow.compute_idf(desc, valid, docs, port_bits, device="cpu")
    tbow.save_vocabulary(str(tmp_path / "port.npz"), port_bits, port_idf)
    ref_bits = jbow.train_vocabulary_jax(desc, n_words=256, iters=2, seed=12)
    ref_idf = jbow.compute_idf(desc, valid, docs, ref_bits)
    np.savez_compressed(tmp_path / "ref.npz", bits=ref_bits, idf=ref_idf)

    q = desc[::7][:300]
    qv = np.ones(len(q), bool)
    qv[::5] = False
    for name in ("port.npz", "ref.npz"):
        bits, idf = tbow.load_vocabulary(str(tmp_path / name))
        with np.load(tmp_path / name) as data:   # as the JAX package reads it
            jb, ji = data["bits"].astype(np.uint8), data["idf"].astype(np.float32)
        np.testing.assert_array_equal(bits, jb)
        np.testing.assert_array_equal(idf, ji)
        vj = np.asarray(jbow.bow_vector(jnp.asarray(q), jnp.asarray(qv),
                                        jnp.asarray(jb), jnp.asarray(ji)))
        vt = tbow.bow_vector(torch.from_numpy(q), torch.from_numpy(qv),
                             torch.from_numpy(tbow.pack_vocabulary(bits)),
                             torch.from_numpy(idf)).numpy()
        np.testing.assert_allclose(vt, vj, rtol=1e-6, atol=1e-7)
        assert (vt > 0).sum() > 20


def test_default_vocab_tool_runs(tmp_path, capsys):
    """The asset tool end to end on the CPU at a small size: the first two
    corpus images, 256 words, one iteration; the file loads in both
    packages' format."""
    from orbslam2_tpu_torch.tools import train_default_vocab as tool

    assert len(tool.scenes()) == 20
    out = tmp_path / "vocab.npz"
    tool.main(["--out", str(out), "--device", "cpu", "--max-images", "2",
               "--words", "256", "--iters", "1"])
    assert "2 images" in capsys.readouterr().out
    bits, idf = tbow.load_vocabulary(str(out))
    assert bits.shape == (256, 256) and set(np.unique(bits)) <= {0, 1}
    assert idf.shape == (256,) and np.isfinite(idf).all()
    assert idf.min() >= 0.0 and idf.max() <= np.log(2) + 1e-6


def test_train_vocab_example_on_a_saved_map(tmp_path):
    """examples/train_vocab: a saved map's keyframe descriptors, trained as
    the numpy trainer trains them."""
    from orbslam2_tpu_torch.examples import train_vocab
    from orbslam2_tpu_torch.config import (CameraConfig, ExtractorConfig,
                                           MapCapacityConfig, SlamConfig)
    from orbslam2_tpu_torch.map.state import MapState
    from orbslam2_tpu_torch.utils.checkpoint import save_map

    cfg = SlamConfig(sensor="rgbd",
                     camera=CameraConfig(fx=300, fy=300, cx=160, cy=120, width=320,
                                         height=240, bf=30.0, fps=30),
                     extractor=ExtractorConfig(n_features=64, n_levels=2),
                     capacity=MapCapacityConfig(max_keyframes=8, max_map_points=64))
    m = MapState.allocate(cfg, device="cpu")
    desc, _ = _clustered(n=4 * 64, n_seeds=16, seed=8)
    N = cfg.extractor.max_keypoints
    rng = np.random.default_rng(8)
    for k in range(4):
        d = np.zeros((N, 32), np.uint8)
        d[:64] = desc[64 * k:64 * (k + 1)]
        fv = np.zeros(N, bool)
        fv[:64] = rng.random(64) < 0.8
        m.add_keyframe(np.eye(4, dtype=np.float32), np.zeros((N, 2), np.float32), d,
                       np.zeros(N, np.int32), np.zeros(N, np.float32), fv,
                       frame_id=k, timestamp=float(k))
    save_map(str(tmp_path / "map.npz"), m)
    train_vocab.main([str(tmp_path / "map.npz"), str(tmp_path / "v.npy"),
                      "--words", "32", "--iters", "2", "--device", "cpu"])
    got = np.load(tmp_path / "v.npy")
    flat = m.kf_desc[: m.n_kf][m.kf_feat_valid[: m.n_kf]]
    np.testing.assert_array_equal(got, jbow.train_vocabulary(flat, n_words=32, iters=2))
