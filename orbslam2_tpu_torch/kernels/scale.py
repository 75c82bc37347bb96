"""Scale-pyramid tables that kernels O, Q, S and T read, and their plain
versions index: sf^level, sf^(2 level) (the octave's sigma^2) and
sf^k for k in [-(L-1), L-1], for L = MAX_LEVELS octaves.

Made on the host once per scale factor, in float32 by the same
``torch.pow`` as the plain versions used to compute them per element, so
a kernel and its plain version read identical numbers; copied to each
device once.
"""

from __future__ import annotations

import functools

import torch

MAX_LEVELS = 32


@functools.lru_cache(maxsize=None)
def _host(sf: float) -> dict:
    sf_t = torch.tensor(sf, dtype=torch.float32)
    lv = torch.arange(MAX_LEVELS, dtype=torch.float32)
    signed = torch.arange(-(MAX_LEVELS - 1), MAX_LEVELS, dtype=torch.float32)
    return dict(pow=torch.pow(sf_t, lv), sig2=torch.pow(sf_t, 2.0 * lv),
                signed=torch.pow(sf_t, signed))


@functools.lru_cache(maxsize=None)
def log_sf(sf: float) -> float:
    """log(sf) in float32, as a Python float."""
    return float(torch.log(torch.tensor(sf, dtype=torch.float32)))


@functools.lru_cache(maxsize=None)
def _table(sf: float, name: str, radius: float, device: str) -> torch.Tensor:
    t = _host(sf)[name]
    if radius != 1.0:
        t = radius * t
    return t.to(device)


def table(sf: float, name: str, device, radius: float = 1.0) -> torch.Tensor:
    """``radius`` times table ``name`` ("pow", "sig2" or "signed") on
    ``device``; shared, never to be written."""
    return _table(float(sf), name, float(radius), str(torch.device(device)))
