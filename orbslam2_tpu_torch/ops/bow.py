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
"""

from __future__ import annotations

import functools
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels import bow_words as _bow_words

VOCAB_SIZE = 65536
VOCAB_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "assets", "vocabulary.npz")


@functools.lru_cache()
def random_vocabulary(n_words: int = VOCAB_SIZE, seed: int = 7) -> np.ndarray:
    """Deterministic random binary vocabulary, bits (W, 256) in {0,1}."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2, size=(n_words, 256)).astype(np.uint8)


@functools.lru_cache()
def default_vocabulary(n_words: int = VOCAB_SIZE
                       ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(bits (W, 256) uint8, idf (W,) float32 or None): the trained asset,
    or the random vocabulary with no IDF where the asset is missing or
    sized differently."""
    if os.path.exists(VOCAB_PATH):
        with np.load(VOCAB_PATH) as data:
            bits = data["bits"].astype(np.uint8)
            if bits.shape[0] == n_words:
                idf = data["idf"].astype(np.float32) if "idf" in data else None
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
