"""Build the CUDA sources in ``csrc/`` at first use and load them.

Each source is compiled by ``nvcc`` into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds) for sm_90a, and
loaded with ``ctypes``.  Libraries land in ``stable_nerf_tpu_torch/_build/``
under a name keyed on a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is reused.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C signatures of the exported functions, by source name
_SIGNATURES = {
    "hash_scatter": {
        "hash_scatter_add": ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p], ctypes.c_int),
    },
    "hash_encode": {
        "hash_encode_forward": ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
                                ctypes.c_int),
        "hash_encode_backward": ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
                                 ctypes.c_int),
    },
    "sorted_gather": {
        "sorted_window_gather": ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source that has no current library, all nvcc
    processes started together.  Returns {name: ptxas report}."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
        os.replace(tmp, out)
        reports[name] = log
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _loaded:
        build([name])
        lib = ctypes.CDLL(_lib_path(name))
        for fn, (argtypes, restype) in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _loaded[name] = lib
    return _loaded[name]


def kernel_sources():
    """Names of every CUDA source of the package."""
    return sorted(_SIGNATURES)
