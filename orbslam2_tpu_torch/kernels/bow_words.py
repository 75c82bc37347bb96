"""Kernel Y wrapper: BoW word assignment and the TF-IDF vector.

Replaces ``orbslam2_tpu/ops/bow.py``: ``bow_vector`` (a (N, 256) x (256, W)
Hamming matmul, argmin over the W words, a scatter-add of the counts, x IDF,
L1 normalisation). CUDA source: ``csrc/bow_words.cu`` (the nearest word per
descriptor by XOR and popcount against the vocabulary in shared-memory
tiles, a 64-bit atomicMin of (distance << 32 | word) per descriptor, so the
(N, W) distance matrix never reaches memory and ties go to the first word;
then one block for the histogram, the IDF weights and the L1 normalisation
by a fixed-order sum). Words are bit-exact against the plain version, the
vector within float32 rounding of its sum.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch

from . import build
from ..ops import matching

NAME = "bow_words"
FUNCTION = "bow_words"  # both its __global__ functions hold this name
SOURCE = "orbslam2_tpu_torch/kernels/csrc/bow_words.cu"
REPLACES = "orbslam2_tpu/ops/bow.py:234"
launches = 0

_ROWS = 256  # descriptors a chunk of the plain version's distance matrix
_unpacked = None  # (vocab, its float bits (W, 256), their row sums)
_unpacked_lock = threading.Lock()


def _vocab_bits(vocab: torch.Tensor):
    """The float {0,1} bits of ``vocab`` and their row sums, kept for the
    last vocabulary seen (a database reuses one for every call)."""
    global _unpacked
    with _unpacked_lock:
        if _unpacked is None or _unpacked[0] is not vocab:
            vb = matching.unpack_bits(vocab).float()
            _unpacked = (vocab, vb, vb.sum(1))
        return _unpacked[1], _unpacked[2]


def bow_words_plain(desc, valid, vocab, idf=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(words (N,) int32, -1 outside ``valid``; the vector (W,) float32):
    the reference's formulation, Hamming distances as |a| + |b| - 2 a.b of
    the unpacked bits in float32 (exact below 2^24; a row's |a| moves none
    of its argmins and is left out), argmin with the first word on ties,
    chunked over the rows."""
    vb, vsum = _vocab_bits(vocab)
    N, W = desc.shape[0], vocab.shape[0]
    words = torch.full((N,), -1, dtype=torch.int32, device=desc.device)
    rows = valid.nonzero()[:, 0]
    for s in range(0, rows.numel(), _ROWS):
        r = rows[s:s + _ROWS]
        b = matching.unpack_bits(desc[r]).float()
        words[r] = torch.addmm(vsum, b, vb.T, alpha=-2.0).argmin(1).to(torch.int32)
    tf = torch.zeros(W, dtype=torch.float32, device=desc.device)
    tf.index_add_(0, words[rows].long(),
                  torch.ones(rows.numel(), dtype=torch.float32, device=desc.device))
    if idf is not None:
        tf = tf * idf
    return words, tf / torch.clamp_min(tf.sum(), 1e-9)


def bow_words(desc, valid, vocab, idf: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel Y on CUDA tensors, the plain version on CPU tensors: (words
    (N,) int32, -1 outside ``valid``; the L1-normalized vector (W,)
    float32) of packed (N, 32) descriptors over the packed (W, 32)
    vocabulary, weighted by ``idf`` (W,) where given."""
    if desc.device.type == "cpu":
        return bow_words_plain(desc, valid, vocab, idf)
    dev = desc.device
    N, W = desc.shape[0], vocab.shape[0]
    specs = [("desc", desc, torch.uint8, (N, 32)),
             ("valid", valid, torch.bool, (N,)),
             ("vocab", vocab, torch.uint8, (W, 32))]
    if idf is not None:
        specs.append(("idf", idf, torch.float32, (W,)))
    build.expect(NAME, dev, specs)
    # the kernel reads descriptors and words as 16-byte vectors
    desc = desc if desc.data_ptr() % 16 == 0 else desc.clone()
    if vocab.data_ptr() % 16:
        raise ValueError(f"{NAME}: vocab must be 16-byte aligned")
    key = torch.empty(max(N, 1), dtype=torch.int64, device=dev)
    words = torch.empty(N, dtype=torch.int32, device=dev)
    vec = torch.empty(W, dtype=torch.float32, device=dev)
    err = build.library().osl_bow_words(
        desc.data_ptr(), valid.data_ptr(), N, vocab.data_ptr(), W,
        idf.data_ptr() if idf is not None else None, int(idf is not None),
        key.data_ptr(), words.data_ptr(), vec.data_ptr(),
        build.stream_handle(dev))
    build.check(err, NAME)
    build.count_launch(__name__)
    return words, vec
