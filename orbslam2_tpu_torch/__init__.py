"""orbslam2_tpu_torch — the ORB-SLAM2-class engine in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of ``orbslam2_tpu`` (the JAX reference package, which stays in the
repository unchanged). The tree mirrors the reference one-to-one, so
``orbslam2_tpu.X.f`` has its counterpart at ``orbslam2_tpu_torch.X.f``:

  system.py              SlamSystem facade (synchronous RGB-D, stereo and
                         monocular paths)
  pipeline.py            AsyncSlamSystem: pipelined tracking, the mapping
                         and loop-closing workers, background global BA
  warmup.py              kernel build and a scratch frame before tracking
  tracking.py            Tracker: extraction -> fused tracking cascade
  local_mapping.py       LocalMapper: triangulation, fuse, local BA
  loop_closing.py        LoopCloser: detection, Sim3, correction, essential
                         graph, global BA
  map/state.py           host numpy map + device keyframe mirror
  ops/                   extraction, matching, pose LM, BA, geometry, Sim3
                         solvers, pose graph
  kernels/               CUDA C++ kernels (csrc/), their wrappers, plain
                         PyTorch twins and launch counters

Every tensor lives on the ``device`` handed to ``SlamSystem``. Each kernel
wrapper runs its plain PyTorch twin for a CPU tensor and launches the CUDA
kernel for a CUDA tensor. Nothing here imports JAX.
"""

import torch as _torch

__version__ = "0.1.0"

# float32 everywhere: the resize matmuls and the BA / pose solvers are
# compared against float32 references, and TF32 keeps ~3 decimal digits.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
