"""The port's device: the card unless the caller asks for another, and the
copies to and from it that must not block the host.

Every entry point (``SlamSystem``, ``AsyncSlamSystem``, ``Tracker``,
``MapState.allocate``, ``OrbExtractor``,
``utils.convert.map_state_from_numpy``) takes ``device=DEFAULT`` and
resolves it here. Without a CUDA device the default fails; it never moves
to the CPU unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

DEFAULT = "cuda"


def resolve(device=DEFAULT) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"orbslam2_tpu_torch: device {str(dev)!r} asked for (the default), "
            "but no CUDA device is available; pass device='cpu' to run on "
            "the CPU")
    return dev


def on(device):
    """The context a worker thread runs its device work in: ``device``
    made the thread's current CUDA device (a kernel launch goes to the
    calling thread's current device); nothing for the CPU."""
    dev = torch.device(device)
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def upload(a: np.ndarray, device) -> torch.Tensor:
    """A copy of a host array on ``device``. To the card it is staged in
    pinned memory and copied without blocking the host (the pinned block is
    not reused before the copy has run), where a copy from pageable memory
    would wait for the stream to drain."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return torch.from_numpy(np.array(a, order="C", copy=True))
    return torch.from_numpy(np.ascontiguousarray(a)).pin_memory().to(
        dev, non_blocking=True)


class HostCopy:
    """A device tensor's copy to the host, started without blocking: on the
    card into pinned memory (``into``, else a new pinned buffer) with an
    event recorded after it on the current stream; a CPU tensor is its own
    copy. ``done()`` says whether the copy has landed, ``result()`` waits
    for it and returns the host tensor."""

    def __init__(self, t: torch.Tensor, into: Optional[torch.Tensor] = None):
        self._event = None
        if t.device.type != "cuda":
            self._host = t
            return
        self._host = into if into is not None else torch.empty(
            t.shape, dtype=t.dtype, pin_memory=True)
        self._host.copy_(t, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record(torch.cuda.current_stream(t.device))

    def done(self) -> bool:
        return self._event is None or self._event.query()

    def result(self) -> torch.Tensor:
        if self._event is not None:
            self._event.synchronize()
        return self._host
