"""Build and load the CUDA kernels: nvcc into one shared library, ctypes.

The sources under ``csrc/`` have a plain C interface, so they compile in
seconds without PyTorch's headers. One nvcc per source, all started
together, then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
         -Xcompiler -fPIC -c -o <tmp>/<source>.o csrc/<source>.cu   (each)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
         -o <build>/libosl_kernels_<hash>.so <tmp>/*.o

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
import sys
import tempfile
import threading
import time
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, "kernels", "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "orbslam2_tpu_torch")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
                           "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes of every entry point; pointers and the stream are c_void_p (a
# bare Python int would be passed as a 32-bit int and cut the pointer)
_SIGNATURES = {
    "osl_fast_score_nms": [_P, _P, _P, _I, _I, _I, _P],
    "osl_orb_describe": [_P, _P, _P, _I, _P, _I, _I, _I, _P, _P, _P],
    "osl_hamming_top2_gated": [_P] * 6 + [_I] + [_P] * 5 + [_I] * 4 + [_P, _I]
    + [_P] * 5,
    "osl_pose_lm": [_P] * 5 + [_I] + [_F] * 5 + [_I, _I, _P, _I] + [_P] * 5,
    "osl_ba_linearize": [_P] * 8 + [_I] * 3 + [_F] * 5 + [_I] + [_P] * 6,
    "osl_ba_solve": [_P] * 5 + [_I] + [_P] * 4,
    "osl_ba_update_cost": [_P] * 12 + [_I] * 3 + [_F] * 5 + [_I] + [_P] * 5,
    "osl_ba_accept": [_P] * 7 + [_I, _I, _P],
    "osl_pyramid_level": [_P, _I] + [_P] * 4 + [_I, _I] + [_F] * 7
    + [_P, _P, _I, _I, _P],
    "osl_orb_select": [_P, _P, _I, _I, _I, _F, _F, _F, _I] + [_P] * 6,
    "osl_rgbd_depth": [_P, _I, _I, _P, _P, _I, _F, _F, _F, _I] + [_F] * 9
    + [_P] * 4,
    "osl_point_attrs": [_P, _P, _P, _I] + [_P] * 4 + [_I, _I, _F, _F, _P, _P],
    "osl_project_gate": [_P] * 6 + [_I] + [_F] * 5 + [_I, _I, _F, _F, _P, _I,
                                                        _P, _I] + [_P] * 6,
    "osl_claim_resolve": [_P] * 5 + [_I] + [_P] * 3 + [_I, _P, _I, _F, _P, _I]
    + [_P] * 7,
    "osl_cascade_pack": [_P] * 10 + [_I, _P, _P, _I, _F, _P, _P],
    "osl_fuse_match": [_P] * 8 + [_I] * 3 + [_F] * 4 + [_I, _I, _P, _I]
    + [_P] * 4,
    "osl_triangulate": [_P] * 15 + [_I, _I] + [_P] * 5 + [_F] * 3
    + [_I, _P, _P, _I, _F] + [_P] * 8,
    "osl_match_rot": [_P] * 4 + [_I] + [_P] * 4 + [_I, _F, _I, _I, _F, _I, _I,
                                                   _F, _F] + [_P] * 8,
    "osl_stereo_match": [_P] * 4 + [_I] + [_P] * 4 + [_I, _P, _F, _F] + [_P] * 3,
    "osl_stereo_sad": [_P, _P, _I, _I, _P, _P, _P, _I, _F, _P, _P, _P],
    "osl_two_view_hypotheses": [_P, _P, _P, _I, _P, _P, _P, _P],
    "osl_two_view_refine": [_P, _P, _P, _I, _P, _P] + [_F] * 4 + [_P] * 3,
    "osl_two_view_check": [_P, _P, _P, _I] + [_F] * 4 + [_P] * 7,
    "osl_two_view_select": [_P, _I] + [_P] * 8,
    "osl_bow_words": [_P, _P, _I, _P, _I, _P, _I, _P, _P, _P, _P],
    "osl_pnp_ransac": [_P] * 4 + [_I, _P, _I] + [_F] * 4 + [_I] + [_P] * 6,
    "osl_sim3_ransac": [_P] * 5 + [_I, _P, _I] + [_F] * 4 + [_I, _F, _I]
    + [_P] * 5,
    "osl_sim3_opt": [_P] * 8 + [_I] + [_F] * 4 + [_I, _F, _I, _I] + [_P] * 6,
    "osl_sim3_search": [_P] * 6 + [_I] + [_P] * 6 + [_I, _P] + [_F] * 4
    + [_I, _I, _F, _P, _I] + [_P] * 5,
    "osl_cholesky_solve_blocked": [_P, _I, _P, _P, _P],
    "osl_ba_solve_blocked": [_P] * 5 + [_I] + [_P] * 6,
    "osl_pose_graph": [_P] * 8 + [_I] * 4 + [_P] * 4,
    "osl_pose_graph_cg": [_P] * 10 + [_I] * 5 + [_P] * 4,
    "osl_pose_chain": [_P, _P, _I, _P, _P],
}

_lib: Optional[ctypes.CDLL] = None
build_seconds: float = 0.0
# the asynchronous system calls the wrappers from the tracking thread and
# the mapping, loop-closing and global-BA workers at once: the library is
# built and loaded under one lock, and every launch count moves under another
_lib_lock = threading.Lock()
launch_lock = threading.Lock()


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
    returns its path. Builds in a temporary directory and moves the library
    into place last, so a concurrent process never loads a half-written
    file."""
    global build_seconds
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    cu = [p for p in _sources() if p.endswith(".cu")]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(p)[:-3] + ".o") for p in cu]
        procs = [subprocess.Popen(
            [nvcc] + NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
            + ["-c", "-o", obj, src], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for src, obj in zip(cu, objs)]
        failed = []
        for src, proc in zip(cu, procs):
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(src)} ({proc.returncode}):\n{err}")
            elif verbose:
                print(f"{os.path.basename(src)}:\n{err}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        lib = os.path.join(tmp, "lib.so")
        proc = subprocess.run([nvcc] + ARCH_FLAGS + ["-shared", "-o", lib] + objs,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(lib, out)
    build_seconds = time.perf_counter() - t0
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call, by one thread)."""
    global _lib
    with _lib_lock:
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


def count_launch(module_name: str):
    """Add one to the ``launches`` count of the wrapper module
    ``module_name``: each wrapper calls it once where it launches its
    kernel, and nowhere else."""
    mod = sys.modules[module_name]
    with launch_lock:
        mod.launches += 1


def check(err: int, name: str):
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = library().osl_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def expect(name: str, device, specs):
    """Raise unless each (label, tensor, dtype, shape) of ``specs`` is a
    contiguous tensor of that dtype and shape on ``device``."""
    for label, t, dtype, shape in specs:
        if (t.device != device or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"{name}: {label} must be a contiguous {dtype} {shape} on "
                f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def gate_args(gate):
    """(pointer, threshold) of a device gate ``(count, threshold)``: a
    gated launch runs only while the () int32 ``count`` on the device is
    below ``threshold``. (None, 0) without a gate."""
    if gate is None:
        return None, 0
    count, threshold = gate
    return count.data_ptr(), int(threshold)


def gate_open(gate) -> bool:
    """The plain versions' reading of a gate (a host sync on the card)."""
    return gate is None or int(gate[0]) < int(gate[1])


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
