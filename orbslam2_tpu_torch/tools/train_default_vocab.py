"""Build the port's default vocabulary asset (the ORBvoc.txt replacement).

Renders a varied corpus (12 box rooms x 14 views across all four texture
styles, and 8 street-like corridors of segmented facades x 16 views, at
640x480), extracts ORB descriptors (1500 features, 8 levels) on the device,
trains the flat 65536-word vocabulary by binary k-means on kernels Y and Y'
(``ops/bow.train_vocabulary_device``, 4 iterations), computes each word's
IDF over the training images, and writes ``assets/vocabulary.npz`` of the
package (``bits`` (W, 256) uint8, ``idf`` (W,) float32), or the path
given. The format is the reference asset's: either package loads it.

    python -m orbslam2_tpu_torch.tools.train_default_vocab [--out PATH]
        [--device cuda] [--workers N] [--max-images N]

``--workers`` renders the scenes in that many processes (the render is host
numpy, most of the run); the device is the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional, Tuple

import numpy as np

from ..config import ExtractorConfig
from ..device import DEFAULT as DEFAULT_DEVICE, resolve as resolve_device
from ..ops import bow, orb
from ..utils.synthetic import make_box_room, make_corridor, orbit_trajectory, render

WIDTH, HEIGHT = 640, 480
K = np.array([[520.0, 0, 320], [0, 520, 240], [0, 0, 1]], np.float32)
ROOMS, ROOM_VIEWS = 12, 14
CORRIDORS, CORRIDOR_VIEWS = 8, 16
N_FEATURES, N_LEVELS = 1500, 8
ITERS = 4


def corridor_view(z: float, sway: float = 0.0) -> np.ndarray:
    """Tcw of a camera at (sway, 0, z) looking down the corridor (+z)."""
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = -np.array([sway, 0.0, z], np.float32)
    return T


def scenes() -> List[Tuple[str, int]]:
    """The corpus's scenes in order: ("room", seed), then ("corridor", seed)."""
    return ([("room", s) for s in range(ROOMS)]
            + [("corridor", s) for s in range(CORRIDORS)])


def render_scene(scene: Tuple[str, int]) -> List[np.ndarray]:
    """The views of one scene, float32 grey images (HEIGHT, WIDTH)."""
    kind, seed = scene
    if kind == "room":
        planes = make_box_room(seed=seed, styles=None)  # style variety
        traj = orbit_trajectory(2 * ROOM_VIEWS, radius=0.9, advance=0.06,
                                yaw_rate=0.09 + 0.02 * seed)
        poses = traj[::2]
    else:
        planes = make_corridor(seed=300 + seed, length=40.0)
        poses = [corridor_view(2.0 * i, 0.3 * np.sin(0.5 * i))
                 for i in range(CORRIDOR_VIEWS)]
    return [render(planes, K, T, WIDTH, HEIGHT).astype(np.float32) for T in poses]


def render_scenes(todo: List[Tuple[str, int]], workers: int = 1
                  ) -> List[np.ndarray]:
    """Every view of the scenes ``todo`` in order, in ``workers`` processes."""
    if workers > 1 and len(todo) > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(min(workers, len(todo)),
                                 mp_context=multiprocessing.get_context("spawn")) as pool:
            views = list(pool.map(render_scene, todo))
    else:
        views = [render_scene(sc) for sc in todo]
    return [img for v in views for img in v]


def render_corpus(workers: int = 1, max_images: Optional[int] = None
                  ) -> List[np.ndarray]:
    """Every view of every scene in order (the first ``max_images`` only,
    rendering no scene past them), in ``workers`` processes."""
    todo, n = [], 0
    for sc in scenes():
        if max_images is not None and n >= max_images:
            break
        todo.append(sc)
        n += ROOM_VIEWS if sc[0] == "room" else CORRIDOR_VIEWS
    images = render_scenes(todo, workers)
    return images[:max_images] if max_images is not None else images


def extract_corpus(images: List[np.ndarray], device=DEFAULT_DEVICE
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(desc (M, N, 32) uint8, valid (M, N) bool, doc ids (M, N) int64) of
    the images' ORB features, one document an image."""
    extractor = orb.OrbExtractor(ExtractorConfig(n_features=N_FEATURES,
                                                 n_levels=N_LEVELS),
                                 HEIGHT, WIDTH, device=resolve_device(device))
    descs, valids = [], []
    for img in images:
        f = extractor(img)
        descs.append(f.desc.cpu().numpy())
        valids.append(f.valid.cpu().numpy())
    desc, valid = np.stack(descs), np.stack(valids)
    docs = np.broadcast_to(np.arange(len(images))[:, None], valid.shape)
    return desc, valid, np.ascontiguousarray(docs, np.int64)


def train(desc: np.ndarray, valid: np.ndarray, docs: np.ndarray,
          n_words: int = bow.VOCAB_SIZE, iters: int = ITERS,
          device=DEFAULT_DEVICE, plain: bool = False, timings=None
          ) -> Tuple[np.ndarray, np.ndarray]:
    """(bits (W, 256) uint8, idf (W,) float32): k-means on the valid
    descriptors, then IDF over the documents. With ``timings`` each stage
    is appended as (name, iteration, ms), IDF as ("idf", 0, ms)."""
    d, v, dc = (a.reshape((-1,) + a.shape[2:]) for a in (desc, valid, docs))
    bits = bow.train_vocabulary_device(d[v], n_words=n_words, iters=iters,
                                       device=device, plain=plain,
                                       timings=timings)
    t0 = time.perf_counter()
    idf = bow.compute_idf(d, v, dc, bits, device=device, plain=plain)
    if timings is not None:
        timings.append(("idf", 0, 1e3 * (time.perf_counter() - t0)))
    return bits, idf


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=bow.VOCAB_PATH)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    ap.add_argument("--words", type=int, default=bow.VOCAB_SIZE)
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--max-images", type=int, default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    t0 = time.perf_counter()
    images = render_corpus(args.workers, args.max_images)
    desc, valid, docs = extract_corpus(images, device)
    print(f"{int(valid.sum())} descriptors from {len(images)} images "
          f"({time.perf_counter() - t0:.0f}s)", flush=True)
    bits, idf = train(desc, valid, docs, args.words, args.iters, device)
    bow.save_vocabulary(args.out, bits, idf)
    used = int((idf < np.log(len(images))).sum())
    print(f"saved {args.out}: {args.words} words, {used} seen in training, "
          f"idf range {idf.min():.2f}..{idf.max():.2f} "
          f"({time.perf_counter() - t0:.0f}s)")


if __name__ == "__main__":
    main()
