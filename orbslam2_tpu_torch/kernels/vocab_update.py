"""Kernel Y' wrapper: the majority-vote centre update of vocabulary training.

Replaces ``orbslam2_tpu/ops/bow.py``: ``train_vocabulary_jax``'s ``_update``
(float32 scatter-adds of the unpacked descriptor bits and of the counts by
word, then ``sums / max(counts, 1) > 0.5``, an empty word keeping its
centre). CUDA source: ``csrc/vocab_update.cu`` (integer atomics into the
counts and per-bit sums, one warp a descriptor; then one thread a (word,
byte) writes the packed new centre with bit = ``2 * sum > count``).
Everything stays packed (N, 32) / (W, 32), LSB-first, as kernel Y reads
it. Counts, sums and centres are bit-exact against the plain version.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import build
from ..ops import matching

NAME = "vocab_update"
FUNCTION = "vocab_"  # its two __global__ functions: vocab_accumulate, vocab_vote
SOURCE = "orbslam2_tpu_torch/kernels/csrc/vocab_update.cu"
REPLACES = "orbslam2_tpu/ops/bow.py:147"
launches = 0

_ROWS = 65536  # descriptors a chunk of the plain version's unpacked bits


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 256) {0,1} -> (..., 32) uint8, LSB-first per byte (the inverse
    of ``matching.unpack_bits``)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    b = bits.to(torch.uint8).reshape(bits.shape[:-1] + (32, 8))
    return (b << shifts).sum(-1, dtype=torch.uint8)


def vocab_update_plain(desc, words, centres
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(counts (W,) int32, sums (W, 256) int32, new centres (W, 32) uint8)
    of packed (N, 32) descriptors assigned to ``words`` (N,) int32 over the
    packed old ``centres`` (W, 32), by ``index_add_`` of the unpacked bits
    in chunks of rows. A word's bit is set where 2 * sum > count (the
    reference's float32 sum / count > 0.5 while count < 2^23); a word with
    no descriptor keeps its centre."""
    W, dev = centres.shape[0], desc.device
    counts = torch.zeros(W, dtype=torch.int32, device=dev)
    sums = torch.zeros((W, 256), dtype=torch.int32, device=dev)
    idx = words.long()
    for s in range(0, desc.shape[0], _ROWS):
        i = idx[s:s + _ROWS]
        sums.index_add_(0, i, matching.unpack_bits(desc[s:s + _ROWS]).to(torch.int32))
        counts.index_add_(0, i, torch.ones(i.numel(), dtype=torch.int32, device=dev))
    vote = pack_bits(2 * sums.long() > counts.long()[:, None])
    return counts, sums, torch.where((counts > 0)[:, None], vote, centres)


def vocab_update(desc, words, centres
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel Y' on CUDA tensors, the plain version on CPU tensors: (counts
    (W,) int32, sums (W, 256) int32, new centres (W, 32) uint8) of packed
    (N, 32) descriptors assigned to ``words`` (N,) int32 in [0, W) over the
    packed old ``centres`` (W, 32)."""
    if desc.device.type == "cpu":
        return vocab_update_plain(desc, words, centres)
    dev = desc.device
    N, W = desc.shape[0], centres.shape[0]
    build.expect(NAME, dev, (("desc", desc, torch.uint8, (N, 32)),
                             ("words", words, torch.int32, (N,)),
                             ("centres", centres, torch.uint8, (W, 32))))
    counts = torch.empty(W, dtype=torch.int32, device=dev)
    sums = torch.empty((W, 256), dtype=torch.int32, device=dev)
    new = torch.empty((W, 32), dtype=torch.uint8, device=dev)
    err = build.library().osl_vocab_update(
        desc.data_ptr(), words.data_ptr(), N, centres.data_ptr(), W,
        counts.data_ptr(), sums.data_ptr(), new.data_ptr(),
        build.stream_handle(dev))
    build.check(err, NAME)
    build.count_launch(__name__)
    return counts, sums, new
