"""Map checkpoint / resume (port of ``orbslam2_tpu.utils.checkpoint``).

One compressed ``.npz`` holding every array of the MapState, its scalar
counters and loop edges, and the keyframe database's BoW rows, membership,
vocabulary bits and IDF weights, under the reference's keys: a map saved by
either package loads in the other.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import SlamConfig
from ..device import DEFAULT as DEFAULT_DEVICE
from ..map.state import MapState

_SCALARS = ("n_kf", "n_mp", "next_kf_id")


def save_map(path: str, m: MapState, kfdb=None) -> None:
    arrays = {}
    for f in dataclasses.fields(m):
        if f.name in ("cfg", "loop_edges"):
            continue
        v = getattr(m, f.name)
        if isinstance(v, np.ndarray):
            arrays[f.name] = v
    for s in _SCALARS:
        arrays[s] = np.asarray(getattr(m, s))
    arrays["loop_edges"] = np.asarray(m.loop_edges or np.zeros((0, 2)), np.int64)
    if kfdb is not None:
        arrays["kfdb_bow"] = kfdb.bow_mat
        arrays["kfdb_in_db"] = kfdb.in_db
        arrays["kfdb_vocab"] = kfdb.vocab
        if kfdb.idf is not None:
            arrays["kfdb_idf"] = kfdb.idf
    np.savez_compressed(path, **arrays)


def load_map(path: str, cfg: SlamConfig, kfdb=None,
             device=DEFAULT_DEVICE) -> MapState:
    """A new MapState on ``device`` from the file; the saved shapes win over
    the config's capacities (the tables grow at run time). With ``kfdb``,
    its rows, membership, vocabulary and IDF are the file's (the rows were
    quantized with that vocabulary)."""
    with np.load(path) as data:
        m = MapState.allocate(cfg, device=device)
        for f in dataclasses.fields(m):
            if f.name in ("cfg", "loop_edges", "free_mp", "free_mp_pending") \
                    or f.name in _SCALARS:
                continue
            if f.name in data:
                tgt = getattr(m, f.name)
                src = data[f.name]
                if tgt.shape != src.shape:
                    print(f"[checkpoint] adopting saved capacity for {f.name}: "
                          f"{src.shape} (config allocates {tgt.shape})")
                setattr(m, f.name, src.copy())
        for s in _SCALARS:
            setattr(m, s, int(data[s]))
        m.loop_edges = [tuple(int(x) for x in row) for row in data["loop_edges"]]
        # the free list of recycled point slots, from validity
        m.free_mp = [int(i) for i in range(m.n_mp) if not m.mp_valid[i]]
        m.free_mp_pending = []
        if kfdb is not None and "kfdb_bow" in data:
            kfdb.bow_mat = data["kfdb_bow"].copy()
            kfdb.in_db = data["kfdb_in_db"].copy()
            kfdb.vocab = data["kfdb_vocab"].copy()
            kfdb.idf = data["kfdb_idf"].copy() if "kfdb_idf" in data else None
            kfdb._vocab_dev = kfdb._idf_dev = None  # rebuilt from the file's
            kfdb.map = m
    return m
