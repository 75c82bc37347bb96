"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain twins.

One module per kernel, each holding the wrapper, the plain PyTorch version
of the same function, ``FUNCTION``, the name of the ``__global__`` function
it launches, and ``launches``, a plain integer the wrapper adds one to each
time it launches the CUDA kernel:

  fast_score      A  FAST score + border + 3x3 NMS   (ops/orb.py detect_level)
  describe        B  IC angle + steered BRIEF         (ops/orb.py)
  hamming         C  gated Hamming top-2              (ops/matching.py, tracking)
  pose_lm         D  motion-only LM, 40 iterations    (ops/pose_opt.py)
  ba_linearize    E  BA linearisation + Schur system  (ops/ba.py)
  ba_solve        F  BA damped Cholesky + pose step   (ops/ba.py)
  ba_update_cost  G  BA back-substitution + cost      (ops/ba.py)
  ba_accept       H  BA LM accept / reject            (ops/ba.py)

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor it
launches the kernel (built by ``build.library()`` at first use) or raises.
"""

from . import (ba_accept, ba_linearize, ba_solve, ba_update_cost, describe,
               fast_score, hamming, pose_lm)

KERNELS = (fast_score, describe, hamming, pose_lm, ba_linearize, ba_solve,
           ba_update_cost, ba_accept)


def reset_launches():
    for mod in KERNELS:
        mod.launches = 0


def launch_counts() -> dict:
    return {mod.NAME: mod.launches for mod in KERNELS}
