"""Hash-table gradient scatter-add: wrapper of ``csrc/hash_scatter.cu`` and
its plain PyTorch version.

Counterpart of stable_nerf_tpu/ops/pallas/scatter.py::hash_scatter_add_per_level,
which sorts the updates and calls the Pallas kernels K1
(scatter_v2.py::sorted_block_scatter_add_v2, 4096-entry blocks) or K2
(scatter.py::sorted_block_scatter_add, 1024-entry blocks).  Both compute
``out[L'·T, F] = zeros.at[idx].add(upd)``; the CUDA kernel serves both
table sizes with unsorted f32 atomics (design and bound in the source).

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.  ``hash_scatter_add_per_level.launches``
counts the wrapper's calls that launched (one a call, however many grids
the C function starts for it).
"""

from __future__ import annotations

import torch


def _check(idx: torch.Tensor, upd: torch.Tensor):
    if idx.dim() != 3 or upd.dim() != 4 or tuple(upd.shape[:3]) != tuple(idx.shape):
        raise ValueError(f"expected idx [M, L', C] and upd [M, L', C, F], got "
                         f"{tuple(idx.shape)} and {tuple(upd.shape)}")
    if idx.dtype != torch.int32 or upd.dtype != torch.float32:
        raise TypeError(f"expected int32 idx and float32 upd, got {idx.dtype} "
                        f"and {upd.dtype}")
    if not (idx.is_contiguous() and upd.is_contiguous()):
        raise ValueError("idx and upd must be contiguous")
    if idx.device != upd.device:
        raise ValueError(f"idx on {idx.device} but upd on {upd.device}")


def hash_scatter_add_plain(idx: torch.Tensor, upd: torch.Tensor, total: int,
                           round_bf16: bool) -> torch.Tensor:
    """The plain version: masked ``index_add_`` in f32, with the same bf16
    rounding of each update (round to nearest even) when asked."""
    F = upd.shape[-1]
    u = upd.reshape(-1, F)
    if round_bf16:
        u = u.to(torch.bfloat16).float()
    flat = idx.reshape(-1)
    keep = (flat >= 0) & (flat < total)
    out = torch.zeros((total, F), dtype=torch.float32, device=upd.device)
    return out.index_add_(0, flat[keep].long(), u[keep])


def hash_scatter_add_per_level(idx: torch.Tensor, upd: torch.Tensor,
                               n_levels: int, table_size: int,
                               payload_bf16: bool = False) -> torch.Tensor:
    """Scatter-add per-level updates into a [n_levels·table_size, F] table.

    Args:
      idx: [M, L', C] int32 rows (level l's rows in [l·T, (l+1)·T)); rows
        outside [0, n_levels·table_size) are dropped.
      upd: [M, L', C, F] float32.
      payload_bf16: round each update to bf16 before the f32 sum (F = 2
        only, as in the reference's packed payload).

    Returns: [n_levels·table_size, F] float32.
    """
    _check(idx, upd)
    total = n_levels * table_size
    if total >= 2 ** 31:
        raise ValueError(f"{n_levels}·{table_size} rows do not fit int32 indices")
    F = upd.shape[-1]
    round_bf16 = bool(payload_bf16 and F == 2)
    if idx.device.type == "cpu":
        return hash_scatter_add_plain(idx, upd, total, round_bf16)
    if idx.device.type != "cuda":
        raise ValueError(f"no scatter kernel for device {idx.device}")
    from .build import load

    out = torch.zeros((total, F), dtype=torch.float32, device=upd.device)
    if idx.numel() == 0 or total == 0:
        return out
    M, Lp, C = idx.shape
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream(idx.device).cuda_stream
        rc = load("hash_scatter").hash_scatter_add(
            idx.data_ptr(), upd.data_ptr(), out.data_ptr(), M, Lp, C, n_levels,
            table_size, F, int(round_bf16), stream)
    if rc != 0:
        raise RuntimeError(f"hash_scatter_add launch failed: CUDA error {rc}")
    hash_scatter_add_per_level.launches += 1
    return out


hash_scatter_add_per_level.launches = 0
