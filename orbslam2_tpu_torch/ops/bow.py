"""Bag-of-binary-words place recognition (port of ``orbslam2_tpu.ops.bow``,
runtime part).

A flat vocabulary of W = 65536 binary words replaces DBoW2's tree: each
descriptor goes to its nearest word by Hamming distance (kernel Y on the
card, ``kernels/bow_words.py``), the counts are weighted by IDF and
L1-normalized into a (W,) vector, and two vectors score by DBoW2's L1
similarity. The vocabulary and its IDF weights are the port's own copy of
the reference's trained asset (``assets/vocabulary.npz``); a deterministic
random vocabulary with no IDF is the fallback, as in the reference.

The asset stores the words as bits (W, 256) in {0, 1}; kernel Y and its
plain version take them packed to (W, 32) bytes LSB-first, the order in
which ``ops/orb.py`` packs descriptors (a different bit order would
scramble every word silently).

The offline part trains a vocabulary by binary k-means on ORB descriptors
(``train_vocabulary``, ``train_vocabulary_device``): each iteration assigns
every descriptor to its nearest word on kernel Y (words only) and moves each
word to the majority vote of its descriptors on kernel Y' (``kernels/
vocab_update.py``), all packed on the device; ``compute_idf`` weights the
words from a corpus (its document counting stays on the host, as in the
reference). ``tools/train_default_vocab.py`` builds the asset with them.
"""

from __future__ import annotations

import functools
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import DEFAULT as DEFAULT_DEVICE, resolve as resolve_device, upload
from ..kernels import bow_words as _bow_words
from ..kernels import vocab_update as _vocab_update

VOCAB_SIZE = 65536
VOCAB_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "assets", "vocabulary.npz")


@functools.lru_cache()
def random_vocabulary(n_words: int = VOCAB_SIZE, seed: int = 7) -> np.ndarray:
    """Deterministic random binary vocabulary, bits (W, 256) in {0,1}."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2, size=(n_words, 256)).astype(np.uint8)


def load_vocabulary(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(bits (W, 256) uint8, idf (W,) float32 or None) of a vocabulary file
    (``bits`` and, where trained with a corpus, ``idf``): the format of the
    reference's asset, so a vocabulary either package trains loads in the
    other."""
    with np.load(path) as data:
        bits = data["bits"].astype(np.uint8)
        idf = data["idf"].astype(np.float32) if "idf" in data else None
    return bits, idf


def save_vocabulary(path: str, bits: np.ndarray,
                    idf: Optional[np.ndarray] = None):
    """Write ``bits`` (W, 256) {0,1} and ``idf`` (W,) in the asset's format."""
    extra = {} if idf is None else {"idf": np.asarray(idf, np.float32)}
    np.savez_compressed(path, bits=np.asarray(bits, np.uint8), **extra)


@functools.lru_cache()
def default_vocabulary(n_words: int = VOCAB_SIZE
                       ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(bits (W, 256) uint8, idf (W,) float32 or None): the trained asset,
    or the random vocabulary with no IDF where the asset is missing or
    sized differently."""
    if os.path.exists(VOCAB_PATH):
        bits, idf = load_vocabulary(VOCAB_PATH)
        if bits.shape[0] == n_words:
            return bits, idf
    return random_vocabulary(n_words), None


def pack_vocabulary(bits: np.ndarray) -> np.ndarray:
    """(W, 256) {0,1} bits -> (W, 32) uint8, LSB-first per byte."""
    return np.packbits(np.asarray(bits, np.uint8), axis=1, bitorder="little")


def bow_vector(desc: torch.Tensor, valid: torch.Tensor, vocab: torch.Tensor,
               idf: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Packed (N, 32) descriptors -> the L1-normalized TF-IDF vector (W,)
    float32 over the packed (W, 32) ``vocab`` (plain TF with ``idf=None``);
    rows outside ``valid`` count for nothing. Kernel Y on CUDA tensors."""
    return _bow_words.bow_words(desc, valid, vocab, idf)[1]


def l1_score(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 similarity 1 - 0.5 |a - b|_1 of L1-normalized vectors;
    broadcasts (W,) against (..., W)."""
    return 1.0 - 0.5 * torch.sum(torch.abs(a - b), dim=-1)


# ---------------------------------------------------------------------------
# Vocabulary training (offline)
# ---------------------------------------------------------------------------

def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def assign_packed(desc: torch.Tensor, centres: torch.Tensor,
                  plain: bool = False) -> torch.Tensor:
    """Nearest word (N,) int32 of each packed (N, 32) descriptor among the
    packed (W, 32) ``centres``, the first word on ties: kernel Y, words only,
    in calls of at most ``MAX_ROWS`` descriptors (its plain version with
    ``plain=True``)."""
    fn = _bow_words.bow_words_plain if plain else _bow_words.bow_words
    valid = torch.ones(desc.shape[0], dtype=torch.bool, device=desc.device)
    step = _bow_words.MAX_ROWS
    return torch.cat([fn(desc[s:s + step], valid[s:s + step], centres,
                         vector=False)[0]
                      for s in range(0, max(desc.shape[0], 1), step)])


def _kmeans(desc: np.ndarray, n_words: int, iters: int, seed: int,
           train_padded: bool, device=DEFAULT_DEVICE, plain: bool = False,
           timings: Optional[List[Tuple[str, int, float]]] = None) -> np.ndarray:
    """Binary k-means of packed (N, 32) uint8 descriptors into ``n_words``
    words; returns their bits (W, 256) uint8 in {0, 1}.

    The start is the reference's: with N >= W, the rows of
    ``np.random.default_rng(seed).choice(N, W, replace=False)``; with N < W,
    the random vocabulary with its first N words replaced by the
    descriptors, which is trained (``train_padded``, the numpy trainer) or
    returned as it is (the device trainer). Each iteration assigns every
    descriptor on kernel Y and moves the words on kernel Y' (their plain
    versions with ``plain=True``), the descriptors and centres staying
    packed on ``device``. With ``timings`` each stage is synchronised and
    ("assign" | "update", iteration, ms) appended."""
    desc = np.ascontiguousarray(desc, np.uint8)
    n = len(desc)
    rng = np.random.default_rng(seed)
    if n < n_words:
        vocab = random_vocabulary(n_words, seed).copy()
        vocab[:n] = np.unpackbits(desc, axis=1, bitorder="little")
        if not train_padded:
            return vocab
        start = pack_vocabulary(vocab)
    else:
        start = desc[rng.choice(n, n_words, replace=False)]
    dev = resolve_device(device)
    d, centres = upload(desc, dev), upload(start, dev)
    update = (_vocab_update.vocab_update_plain if plain
              else _vocab_update.vocab_update)

    def stage(name, it, fn):
        if timings is None:
            return fn()
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        timings.append((name, it, 1e3 * (time.perf_counter() - t0)))
        return out

    for it in range(iters):
        words = stage("assign", it, lambda: assign_packed(d, centres, plain))
        centres = stage("update", it, lambda: update(d, words, centres)[2])
    return np.unpackbits(centres.cpu().numpy(), axis=1, bitorder="little")


def train_vocabulary(descs: np.ndarray, n_words: int = VOCAB_SIZE,
                     iters: int = 4, seed: int = 7,
                     device=DEFAULT_DEVICE) -> np.ndarray:
    """One-level binary k-means (majority vote) on packed (N, 32)
    descriptors, the reference's numpy ``train_vocabulary``: with fewer
    descriptors than words it trains the random-padded vocabulary. Bits
    (W, 256) uint8."""
    return _kmeans(descs, n_words, iters, seed, True, device)


def train_vocabulary_device(descs: np.ndarray, n_words: int = VOCAB_SIZE,
                            iters: int = 4, seed: int = 7,
                            device=DEFAULT_DEVICE, plain: bool = False,
                            timings=None) -> np.ndarray:
    """The reference's ``train_vocabulary_jax``: the same k-means, but with
    fewer descriptors than words the random-padded vocabulary is returned
    untrained. Bits (W, 256) uint8."""
    return _kmeans(descs, n_words, iters, seed, False, device, plain, timings)


def assign_words(bits: np.ndarray, centers: np.ndarray,
                 device=DEFAULT_DEVICE) -> np.ndarray:
    """Nearest word (N,) int64 of each (N, 256) {0,1} bit row among the
    (W, 256) {0,1} ``centers``, the first on ties (the reference's
    ``assign_words`` / ``assign_words_jax``): both packed, kernel Y."""
    dev = resolve_device(device)
    desc = np.packbits(np.asarray(bits, np.uint8), axis=1, bitorder="little")
    words = assign_packed(upload(desc, dev),
                          upload(pack_vocabulary(centers), dev))
    return words.cpu().numpy().astype(np.int64)


def compute_idf(descs: np.ndarray, valid: np.ndarray, doc_ids: np.ndarray,
                vocab_bits: np.ndarray, device=DEFAULT_DEVICE,
                plain: bool = False) -> np.ndarray:
    """IDF weights (W,) float32 from a training corpus (the reference's
    ``compute_idf``): ``doc_ids`` gives each descriptor's document (image);
    idf[w] = log(n_docs / df[w]) with df the number of documents holding
    w, and log(n_docs) for a word no document holds. The words come from
    kernel Y on the packed descriptors; the document counts from
    ``np.unique`` on the host."""
    dev = resolve_device(device)
    desc = np.ascontiguousarray(np.asarray(descs)[valid], np.uint8)
    docs = np.asarray(doc_ids)[valid]
    assign = assign_packed(upload(desc, dev), upload(pack_vocabulary(vocab_bits), dev),
                           plain).cpu().numpy().astype(np.int64)
    n_docs = max(int(docs.max()) + 1 if len(docs) else 1, 1)
    pair = np.unique(np.stack([assign, docs], axis=1), axis=0)
    df = np.bincount(pair[:, 0], minlength=vocab_bits.shape[0]).astype(np.float64)
    idf = np.log(n_docs / np.maximum(df, 1.0))
    idf[df == 0] = np.log(n_docs)
    return idf.astype(np.float32)
