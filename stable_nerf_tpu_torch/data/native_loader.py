"""ctypes bindings of the native C++ data loader, ``native/dataloader.cpp``
(counterpart of stable_nerf_tpu/data/native_loader.py).

The source is built at first use with ``g++ -O3 -std=c++17 -fPIC -shared
... -lz -lpthread`` into ``stable_nerf_tpu_torch/_build/``, under a name
keyed on a hash of the source and the flags; nothing is written next to
the source.  A failed build or load raises: the port has no other PNG
decoder to fall back to (the card's machine has no PIL).

Functions: ``decode_image`` (PNG bytes → normalized CHW float32, resized
with PIL's BILINEAR triangle filter), ``load_batch`` (threaded decode of
files), ``decode_npy_pose`` (a 4×4 pose from a .npy file), and
``decode_png_uint8`` (a PNG at its own size as uint8 RGB, alpha dropped,
as PIL's ``convert("RGB")`` gives it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import threading
from typing import Sequence, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "dataloader.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
LIBS = ("-lz", "-lpthread")
MAX_PIXELS = 1 << 28        # a corrupt header must not size a huge output buffer

_lib = None
_lock = threading.Lock()


def _lib_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS + LIBS).encode())
    return os.path.join(BUILD_DIR, f"libstn_dataloader-{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the source unless its library exists; returns the library's
    path.  Raises RuntimeError with the compiler's output on failure."""
    if not os.path.exists(SOURCE):
        raise RuntimeError(f"native loader source {SOURCE} not found")
    out = _lib_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, SOURCE, *LIBS],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"g++ could not build {SOURCE}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built first where needed (raises on failure)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        f = ctypes.POINTER(ctypes.c_float)
        lib.stn_decode_image.restype = ctypes.c_int
        lib.stn_decode_image.argtypes = [ctypes.c_char_p, ctypes.c_size_t, f,
                                         ctypes.c_int, ctypes.c_int, f, f]
        lib.stn_load_batch.restype = ctypes.c_int
        lib.stn_load_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, f,
                                       ctypes.c_int, ctypes.c_int, f, f, ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_int)]
        lib.stn_decode_npy_pose.restype = ctypes.c_int
        lib.stn_decode_npy_pose.argtypes = [ctypes.c_char_p, f]
        _lib = lib
        return _lib


def _fp(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def decode_image(data: bytes, shape: Tuple[int, int], mean=(0.5, 0.5, 0.5),
                 std=(0.5, 0.5, 0.5)) -> np.ndarray:
    """PNG bytes → normalized CHW float32 [3, H, W] at ``shape``."""
    lib = load()
    h, w = shape
    out = np.empty((3, h, w), np.float32)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    rc = lib.stn_decode_image(data, len(data), _fp(out), h, w, _fp(mean), _fp(std))
    if rc != 0:
        raise ValueError(f"native PNG decode failed (rc={rc})")
    return out


def load_batch(paths: Sequence[str], shape: Tuple[int, int], mean=(0.5, 0.5, 0.5),
               std=(0.5, 0.5, 0.5), n_threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Threaded decode of PNG files → ([N, 3, H, W] float32, status [N],
    0 where a file decoded)."""
    lib = load()
    h, w = shape
    n = len(paths)
    out = np.empty((n, 3, h, w), np.float32)
    status = np.empty(n, np.int32)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.stn_load_batch(c_paths, n, _fp(out), h, w, _fp(mean), _fp(std), n_threads,
                       status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return out, status


def decode_npy_pose(path: str) -> np.ndarray:
    """A 4×4 pose (f4 or f8, little-endian) from a .npy file."""
    lib = load()
    out = np.empty(16, np.float32)
    rc = lib.stn_decode_npy_pose(path.encode(), _fp(out))
    if rc != 0:
        raise ValueError(f"native npy read failed (rc={rc})")
    return out.reshape(4, 4)


def png_size(data: bytes) -> Tuple[int, int]:
    """(height, width) from a PNG's IHDR chunk."""
    if len(data) < 24 or data[:8] != b"\x89PNG\r\n\x1a\n" or data[12:16] != b"IHDR":
        raise ValueError("not a PNG file")
    w, h = struct.unpack(">II", data[16:24])
    if not 0 < h * w <= MAX_PIXELS:
        raise ValueError(f"PNG of {w}×{h} pixels refused (at most {MAX_PIXELS})")
    return h, w


def decode_png_uint8(data: bytes) -> np.ndarray:
    """A PNG at its own size → [H, W, 3] uint8 RGB, alpha dropped, the
    values PIL's ``convert("RGB")`` gives.  The loader's resize to the
    PNG's own size is the identity (each output pixel takes its own source
    pixel with weight 1), so mean 0 and std 1 return pixel / 255 exactly,
    and rounding × 255 recovers the pixel."""
    chw = decode_image(data, png_size(data), mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0))
    return np.rint(chw.transpose(1, 2, 0) * 255.0).astype(np.uint8)
