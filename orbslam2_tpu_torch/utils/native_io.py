"""ctypes binding for the native C++ data loader (port of
``orbslam2_tpu.utils.native_io``), and a PNG writer.

``native/dataloader.cc`` (the repository's, used as it is) decodes PNGs
(grey 8/16-bit, RGB, RGBA) and runs a prefetching worker pool. The port
builds it at first use into ``build/orbslam2_tpu_torch/`` beside the
package (git-ignored), with ``g++ ... -lz -lpthread``, named by a hash of
the source, as it builds its kernels. Where it cannot be built (no source,
no compiler or no zlib) the loaders fall back to PIL, as the reference's
do when its library is missing. This is host IO: the device is not
involved.

``write_png`` writes grey 8- and 16-bit PNGs with the standard library's
zlib, for machines without PIL.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import tempfile
import threading
import zlib
from typing import List, Optional

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO, "native", "dataloader.cc")
BUILD_DIR = os.path.join(_REPO, "build", "orbslam2_tpu_torch")
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]
LD_FLAGS = ["-lz", "-lpthread"]

_lib = None
_tried = False
_lock = threading.Lock()
build_error: Optional[str] = None  # why the library is not there, if it is not


def library_path() -> Optional[str]:
    """Where the library for this source is built (None without the source)."""
    if not os.path.exists(SOURCE):
        return None
    with open(SOURCE, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(CXX_FLAGS + LD_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"liborbslam_native_{h.hexdigest()[:16]}.so")


def build() -> Optional[str]:
    """Compile the loader unless its library exists; its path, or None
    (with ``build_error`` set) where it cannot be built. Builds in a
    temporary directory and moves the library into place last."""
    global build_error
    out = library_path()
    if out is None:
        build_error = f"no source {SOURCE}"
        return None
    if os.path.exists(out):
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        build_error = "no C++ compiler"
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = os.path.join(tmp, "lib.so")
        proc = subprocess.run([cxx] + CXX_FLAGS + [SOURCE, "-o", lib] + LD_FLAGS,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            build_error = f"{cxx} failed ({proc.returncode}): {proc.stderr[-2000:]}"
            return None
        os.replace(lib, out)
    return out


def _load_lib():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = build()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        fp = ctypes.POINTER(ctypes.c_float)
        ip = ctypes.POINTER(ctypes.c_int)
        lib.dl_load_image.argtypes = [ctypes.c_char_p, fp, ctypes.c_int, ip, ip]
        lib.dl_load_image.restype = ctypes.c_int
        lib.dl_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int]
        lib.dl_create.restype = ctypes.c_void_p
        lib.dl_get.argtypes = [ctypes.c_void_p, ctypes.c_int, fp, ctypes.c_int,
                               ip, ip]
        lib.dl_get.restype = ctypes.c_int
        lib.dl_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def native_available() -> bool:
    return _load_lib() is not None


def _decoded(buf: np.ndarray, w: ctypes.c_int, h: ctypes.c_int) -> np.ndarray:
    return buf[: w.value * h.value].reshape(h.value, w.value).copy()


def load_image(path: str, max_pixels: int = 4096 * 3072) -> np.ndarray:
    """Decode a PNG to float32 grey (8-bit: 0..255; 16-bit: the raw value),
    by the native decoder where it is built, else PIL."""
    lib = _load_lib()
    if lib is None:
        from PIL import Image

        im = Image.open(path)
        if im.mode in ("I;16", "I"):
            return np.asarray(im, dtype=np.float32)
        return np.asarray(im.convert("L"), dtype=np.float32)
    buf = np.empty(max_pixels, np.float32)
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.dl_load_image(path.encode(),
                           buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                           max_pixels, ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise IOError(f"native decode failed ({rc}) for {path}")
    return _decoded(buf, w, h)


class PrefetchingLoader:
    """An image sequence decoded ahead on worker threads (the native pool),
    or one image at a time through ``load_image`` without the library."""

    def __init__(self, paths: List[str], n_workers: int = 2, window: int = 8,
                 max_pixels: int = 4096 * 3072):
        self.paths = list(paths)
        self.max_pixels = max_pixels
        self._lib = _load_lib()
        self._handle = None
        if self._lib is not None and self.paths:
            arr = (ctypes.c_char_p * len(self.paths))(
                *[p.encode() for p in self.paths])
            self._handle = self._lib.dl_create(arr, len(self.paths), n_workers,
                                               window)

    def __len__(self):
        return len(self.paths)

    def get(self, idx: int) -> np.ndarray:
        if self._handle is None:
            return load_image(self.paths[idx], self.max_pixels)
        buf = np.empty(self.max_pixels, np.float32)
        w, h = ctypes.c_int(), ctypes.c_int()
        rc = self._lib.dl_get(self._handle, idx,
                              buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                              self.max_pixels, ctypes.byref(w), ctypes.byref(h))
        if rc != 0:
            raise IOError(f"native prefetch decode failed ({rc}) @ {idx}")
        return _decoded(buf, w, h)

    def close(self):
        if self._handle is not None:
            self._lib.dl_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xffffffff))


def write_png(path: str, img: np.ndarray):
    """Write a 2-D uint8 (grey 8-bit) or uint16 (grey 16-bit) array as a PNG
    with the standard library's zlib (filter 0 on every row)."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"write_png: a 2-D uint8 or uint16 array, got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape
    depth = 8 * img.dtype.itemsize
    rows = np.ascontiguousarray(img.astype(img.dtype.newbyteorder(">")))
    raw = np.zeros((h, 1 + w * img.dtype.itemsize), np.uint8)
    raw[:, 1:] = rows.view(np.uint8).reshape(h, -1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, 0, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))
