"""Train a binary-words vocabulary from a saved map's descriptors.

The flat vocabulary (``ops/bow.py``) trains on the keyframe descriptors of
any map that ``SlamSystem.save_map`` wrote, by binary k-means on kernels Y
and Y', and plugs into ``KeyFrameDatabase(vocab_bits=...)``:

    python -m orbslam2_tpu_torch.examples.train_vocab map.npz vocab.npy \\
        [--words 4096] [--iters 4] [--max-desc 200000] [--device cuda]

Writes the bits (W, 256) uint8 with ``np.save``.
"""

import argparse

import numpy as np

from ..device import DEFAULT as DEFAULT_DEVICE
from ..ops import bow


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("map_npz")
    ap.add_argument("out_npy")
    ap.add_argument("--words", type=int, default=bow.VOCAB_SIZE)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--max-desc", type=int, default=200000)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)

    with np.load(args.map_npz) as data:
        flat = data["kf_desc"][data["kf_feat_valid"]]   # (K, N, 32) -> (n, 32)
    if len(flat) > args.max_desc:
        rng = np.random.default_rng(0)
        flat = flat[rng.choice(len(flat), args.max_desc, replace=False)]
    print(f"training on {len(flat)} descriptors -> {args.words} words")
    vocab = bow.train_vocabulary(flat, n_words=args.words, iters=args.iters,
                                 device=args.device)
    np.save(args.out_npy, vocab)
    print(f"saved {args.out_npy} ({vocab.shape})")


if __name__ == "__main__":
    main()
