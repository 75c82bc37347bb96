"""Interop with the JAX reference package, through numpy only.

The tests hand both packages the same camera, map, keyframe database and
frame: the JAX package's state is read out as numpy arrays (``np.asarray``
of each field) and converted here. Nothing in this module imports JAX or the JAX package;
the BRIEF test pattern is the port's own copy of the reference's trained
asset (``orbslam2_tpu_torch/assets/brief_pattern.npz``).
"""

from __future__ import annotations

import functools
import os
from typing import Tuple

import numpy as np

from ..config import SlamConfig
from ..device import DEFAULT as DEFAULT_DEVICE
from ..device import resolve, upload
from ..map.keyframe_database import KeyFrameDatabase
from ..map.state import MapState
from ..models.camera import Camera
from ..ops.ba import BAProblem

BRIEF_PATTERN_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets",
    "brief_pattern.npz")

_CAMERA_FIELDS = ("fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2", "k3", "bf")


@functools.lru_cache()
def brief_pattern() -> Tuple[np.ndarray, np.ndarray]:
    """The 256 steered-BRIEF test pairs (pa, pb), each (256, 2) int32 (x, y),
    as trained for the reference package (a copy of its
    ``assets/brief_pattern.npz``)."""
    with np.load(BRIEF_PATTERN_PATH) as data:
        return data["pa"].astype(np.int32), data["pb"].astype(np.int32)


def camera_from_numpy(d: dict) -> Camera:
    """Camera from the fields of the reference's ``Camera`` NamedTuple
    (``cam._asdict()`` with each value as a numpy scalar or float)."""
    return Camera.create(*(float(np.asarray(d[k])) for k in _CAMERA_FIELDS),
                         width=int(d["width"]), height=int(d["height"]))


def ba_problem_from_numpy(arrays, device=DEFAULT_DEVICE) -> BAProblem:
    """A BAProblem on ``device`` holding copies of the reference's BA inputs:
    its ``BAProblem``'s eight arrays in field order (``poses``, ``opt_mask``,
    ``points``, ``point_valid``, ``obs_kf``, ``obs_uvr``, ``obs_sigma2``,
    ``obs_valid``), or a dict of them by field name."""
    if isinstance(arrays, dict):
        arrays = [arrays[f] for f in BAProblem._fields]
    dtypes = (np.float32, bool, np.float32, bool, np.int32, np.float32,
              np.float32, bool)
    dev = resolve(device)
    return BAProblem(*(upload(np.asarray(a, dtype=t), dev)
                       for a, t in zip(arrays, dtypes)))


def map_state_from_numpy(cfg: SlamConfig, d: dict,
                         device=DEFAULT_DEVICE) -> MapState:
    """A MapState holding copies of every array field in ``d`` (the
    reference MapState's arrays by field name, e.g. from
    ``{f: getattr(m, f) for f in ...}``), plus its scalar counters."""
    m = MapState.allocate(cfg, device=device)
    for name, value in d.items():
        cur = getattr(m, name)
        if isinstance(cur, np.ndarray):
            setattr(m, name, np.array(value, dtype=cur.dtype, copy=True))
        elif isinstance(cur, list):
            setattr(m, name, list(value))
        else:
            setattr(m, name, type(cur)(value))
    m.dev_kf.invalidate()
    return m


def keyframe_database_from_numpy(m: MapState, d: dict,
                                 device=DEFAULT_DEVICE) -> KeyFrameDatabase:
    """A KeyFrameDatabase over ``m`` holding copies of the reference
    database's arrays in ``d``: ``bow_mat`` (K, W) float16, ``in_db`` (K,),
    ``vocab`` (W, 256) bits and ``idf`` (W,) or None."""
    idf = d.get("idf")
    kfdb = KeyFrameDatabase(m, vocab_bits=np.array(d["vocab"], np.uint8),
                            idf=None if idf is None else np.array(idf, np.float32),
                            device=device)
    kfdb.bow_mat = np.array(d["bow_mat"], np.float16)
    kfdb.in_db = np.array(d["in_db"], bool)
    return kfdb


def set_loop_closer_state(lc, d: dict):
    """Carry the reference LoopCloser's state into the port's ``lc``: its
    ``consistent_groups`` (a list of (set of keyframes, count)),
    ``last_loop_kf``, ``loops_closed`` and ``rng_state``, the state dict of
    its numpy generator (``lc._rng.bit_generator.state``), so both draw the
    same RANSAC samples from here on."""
    lc.consistent_groups = [(set(int(k) for k in g), int(c))
                            for g, c in d.get("consistent_groups", [])]
    lc.last_loop_kf = int(d.get("last_loop_kf", lc.last_loop_kf))
    lc.loops_closed = int(d.get("loops_closed", lc.loops_closed))
    if "rng_state" in d:
        lc._rng.bit_generator.state = d["rng_state"]
    return lc
