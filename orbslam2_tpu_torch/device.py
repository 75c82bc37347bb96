"""The port's device: the card unless the caller asks for another.

Every entry point (``SlamSystem``, ``Tracker``, ``MapState.allocate``,
``OrbExtractor``, ``utils.convert.map_state_from_numpy``) takes
``device=DEFAULT`` and resolves it here. Without a CUDA device the default
fails; it never moves to the CPU unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

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
