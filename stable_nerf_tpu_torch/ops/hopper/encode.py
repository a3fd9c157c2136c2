"""Multiresolution hash encode: wrapper of ``csrc/hash_encode.cu``.

A kernel the port adds; the reference package has no Pallas counterpart
(its encode, stable_nerf_tpu/ops/encoding.py::hash_grid_encode, is XLA's).
``hash_encode_forward`` maps positions [M, 3] to features [M, L·F];
``hash_encode_backward`` gives one level section's rows [M, L', C] int32
and updates [M, L', C, F] f32 in the layout ``hash_scatter_add_per_level``
takes.  Their plain versions are ``ops/encoding.py``'s ``_hash_sections``
and ``_encode_sections``, which ``hash_grid_encode`` runs on a CPU tensor;
these wrappers take CUDA tensors only, launch or raise.

A level table (``LevelParams`` rows) describes the grid: f32 scale,
resolution, dense flag, first row, the one-corner draw's salt, and whether
the level draws one corner.  ``ops/encoding.py::level_table`` builds it
once per grid configuration; it travels to the kernel as an argument, so
no call copies anything to the device.  ``.launches`` on each wrapper
counts its launches.
"""

from __future__ import annotations

import ctypes

import torch

MAX_LEVELS = 32                 # kMaxLevels of csrc/hash_encode.cu
FEATURES = (1, 2, 4, 8)         # the widths the kernel is built for


class LevelParams(ctypes.Structure):
    """One level of the table, laid out as the kernel's ``LevelParams``."""

    _fields_ = [("scale", ctypes.c_float), ("resolution", ctypes.c_uint32),
                ("dense", ctypes.c_uint32), ("offset", ctypes.c_uint32),
                ("salt", ctypes.c_uint32), ("one_corner", ctypes.c_uint32)]


def _check(x: torch.Tensor, other: torch.Tensor, levels, table_size: int, F: int):
    if x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"expected positions [M, 3], got {tuple(x.shape)}")
    if x.dtype != torch.float32 or other.dtype != torch.float32:
        raise TypeError(f"expected float32 tensors, got {x.dtype} and {other.dtype}")
    if not (x.is_contiguous() and other.is_contiguous()):
        raise ValueError("the encode kernel takes contiguous tensors only")
    if x.device.type != "cuda" or other.device != x.device:
        raise ValueError(f"the encode kernel takes tensors on one CUDA device, got "
                         f"{x.device} and {other.device}")
    if F not in FEATURES:
        raise ValueError(f"{F} features a level: the kernel takes {FEATURES}")
    L = len(levels)
    if not 1 <= L <= MAX_LEVELS or L * table_size >= 2 ** 31:
        raise ValueError(f"{L} levels of {table_size} rows: the kernel takes 1 to "
                         f"{MAX_LEVELS} levels and fewer than 2^31 rows")


def _run(fn: str, *args):
    from .build import load

    rc = getattr(load("hash_encode"), fn)(*args)
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: CUDA error {rc}")


def hash_encode_forward(x: torch.Tensor, table: torch.Tensor, levels,
                        table_size: int) -> torch.Tensor:
    """Features [M, L·F] f32 of positions ``x`` [M, 3] f32 from ``table``
    [L·T, F] f32 (both contiguous, on one card), each level interpolated
    over its 8 corners or read at its one drawn corner as ``levels`` (a
    ``LevelParams`` array of L rows) says."""
    F = table.shape[-1] if table.dim() == 2 else 0
    _check(x, table, levels, table_size, F)
    L = len(levels)
    if table.shape[0] != L * table_size:
        raise ValueError(f"table {tuple(table.shape)} is not {L}·{table_size} rows")
    if table.data_ptr() % (4 * min(F, 4)):
        raise ValueError("the table's rows are not aligned for vector loads")
    M = x.shape[0]
    out = torch.empty((M, L * F), dtype=torch.float32, device=x.device)
    if M == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _run("hash_encode_forward", x.data_ptr(), table.data_ptr(), out.data_ptr(), M, L,
             table_size, F, levels, stream)
    hash_encode_forward.launches += 1
    return out


def hash_encode_backward(x: torch.Tensor, g: torch.Tensor, levels, lv0: int, lv1: int,
                         table_size: int):
    """Rows and updates of levels [lv0, lv1) for the scatter kernel: rows
    [M, L', C] int32 local to the section (level lv0 + s in [s·T, (s+1)·T))
    and updates [M, L', C, F] f32, the corner weight times ``g`` [M, L·F]
    (the features' gradient), C = 1 where the section draws one corner,
    else 8.  The section's levels must all be one or the other."""
    L = len(levels)
    F = g.shape[1] // L if g.dim() == 2 else 0
    _check(x, g, levels, table_size, F)
    if tuple(g.shape) != (x.shape[0], L * F) or not 0 <= lv0 < lv1 <= L:
        raise ValueError(f"gradient {tuple(g.shape)} or levels [{lv0}, {lv1}) do not "
                         f"fit {x.shape[0]} samples of {L} levels")
    one = {bool(levels[l].one_corner) for l in range(lv0, lv1)}
    if len(one) != 1:
        raise ValueError(f"levels [{lv0}, {lv1}) mix one corner and eight")
    one_corner = one.pop()
    C = 1 if one_corner else 8
    M, Lp = x.shape[0], lv1 - lv0
    rows = torch.empty((M, Lp, C), dtype=torch.int32, device=x.device)
    upd = torch.empty((M, Lp, C, F), dtype=torch.float32, device=x.device)
    if M == 0:
        return rows, upd
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _run("hash_encode_backward", x.data_ptr(), g.data_ptr(), rows.data_ptr(),
             upd.data_ptr(), M, lv0, Lp, L, table_size, F, int(one_corner), levels, stream)
    hash_encode_backward.launches += 1
    return rows, upd


hash_encode_forward.launches = 0
hash_encode_backward.launches = 0
