"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain twins.

One module per kernel, each holding the wrapper, the plain PyTorch version
of the same function, and ``launches``, a plain integer the wrapper adds one
to each time it launches the CUDA kernel:

  fast_score   A  FAST score + border + 3x3 NMS   (ops/orb.py detect_level)
  describe     B  IC angle + steered BRIEF         (ops/orb.py)
  hamming      C  gated Hamming top-2              (ops/matching.py, tracking)
  pose_lm      D  motion-only LM, 40 iterations    (ops/pose_opt.py)

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor it
launches the kernel (built by ``build.library()`` at first use) or raises.
"""

from . import describe, fast_score, hamming, pose_lm

KERNELS = (fast_score, describe, hamming, pose_lm)


def reset_launches():
    for mod in KERNELS:
        mod.launches = 0


def launch_counts() -> dict:
    return {mod.NAME: mod.launches for mod in KERNELS}
