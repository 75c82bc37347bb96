"""Build and load the CUDA kernels: nvcc into one shared library, ctypes.

The sources under ``csrc/`` have a plain C interface, so they compile in
seconds without PyTorch's headers:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
         -shared -Xcompiler -fPIC -o <build>/libosl_kernels_<hash>.so csrc/*.cu

No ``--use_fast_math``: the BRIEF rotation and the pose LM need the IEEE
cosf/sinf/atan2f/sqrtf, and ``-fmad=false`` keeps nvcc from contracting
``a * b + c`` into one rounding where the plain PyTorch version rounds twice.

The library is built at first use into ``build/orbslam2_tpu_torch/`` beside
the package (a git-ignored directory), named by a hash of the sources so an
edited kernel is rebuilt and an unchanged one is reused within a checkout.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, "kernels", "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "orbslam2_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes of every entry point; pointers and the stream are c_void_p (a
# bare Python int would be passed as a 32-bit int and cut the pointer)
_SIGNATURES = {
    "osl_fast_score_nms": [_P, _P, _P, _I, _I, _I, _P],
    "osl_orb_describe": [_P, _P, _P, _I, _P, _I, _I, _I, _P, _P, _P],
    "osl_hamming_top2_gated": [_P] * 6 + [_I] + [_P] * 5 + [_I] + [_P] * 5,
    "osl_pose_lm": [_P] * 5 + [_I] + [_F] * 5 + [_I, _I] + [_P] * 5,
}

_lib: Optional[ctypes.CDLL] = None
build_seconds: float = 0.0


def _sources():
    return sorted(glob.glob(os.path.join(SRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(SRC_DIR, "*.cuh")))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def library_path() -> str:
    h = hashlib.sha256()
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libosl_kernels_{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> str:
    """Compile the kernels unless the library for these sources exists;
    returns its path. Writes to a temporary name first, so a concurrent
    process never loads a half-written file."""
    global build_seconds
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cu = [p for p in _sources() if p.endswith(".cu")]
    cmd = [_nvcc()] + NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else []) \
        + ["-o", tmp] + cu
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose:
        print(proc.stderr)
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.osl_error_string.argtypes = [ctypes.c_int]
        lib.osl_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, name: str):
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = library().osl_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
