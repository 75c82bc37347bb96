"""Interop with the JAX reference package, through numpy only.

The tests hand both packages the same camera, map and frame: the JAX
package's state is read out as numpy arrays (``np.asarray`` of each field)
and converted here. Nothing in this module imports JAX or the JAX package;
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
from ..map.state import MapState
from ..models.camera import Camera

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
