"""Row gather with bf16 rounding: wrapper of ``csrc/sorted_gather.cu`` and its
plain PyTorch version.

Counterpart of stable_nerf_tpu/ops/pallas/gather.py::sorted_window_gather
(Pallas kernel K3): ``out[M, F] f32 = f32(bf16(table))[clip(sidx, 0, T-1)]``.
The reference kernel needs ``sidx`` sorted ascending and ``T % 4096 == 0``;
this one takes any T and M and is correct on unsorted indices too, where
it only loses the coalescing that sorted indices give its table reads.
Nothing in the package's encode calls it, as in the reference: its caller
is the sorted-encode floor measurement
(scripts/bench_torch_fused_render_floor.py).

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.  ``sorted_window_gather.launches`` counts
kernel launches.  There is no backward: the reference has none.
"""

from __future__ import annotations

import torch


def sorted_window_gather_plain(table: torch.Tensor, sidx: torch.Tensor) -> torch.Tensor:
    """The plain version: round the table to bf16 (nearest even), widen to
    f32, index with the clamped rows."""
    T = table.shape[0]
    return table.to(torch.bfloat16).float()[sidx.clamp(0, T - 1).long()]


def _check(table: torch.Tensor, sidx: torch.Tensor):
    if table.dim() != 2 or sidx.dim() != 1:
        raise ValueError(f"expected table [T, F] and sidx [M], got "
                         f"{tuple(table.shape)} and {tuple(sidx.shape)}")
    if not (1 <= table.shape[0] < 2 ** 31 and 1 <= table.shape[1] < 2 ** 31):
        raise ValueError(f"table {tuple(table.shape)}: rows and width must be "
                         f"in [1, 2^31)")
    if not table.is_floating_point() or sidx.dtype != torch.int32:
        raise TypeError(f"expected a float table and int32 sidx, got "
                        f"{table.dtype} and {sidx.dtype}")
    if not (table.is_contiguous() and sidx.is_contiguous()):
        raise ValueError("table and sidx must be contiguous")
    if table.device != sidx.device:
        raise ValueError(f"table on {table.device} but sidx on {sidx.device}")


def sorted_window_gather(table: torch.Tensor, sidx: torch.Tensor) -> torch.Tensor:
    """Gather bf16-rounded table rows.

    Args:
      table: [T, F] float, contiguous.  float32 is rounded to bf16 in the
        kernel and bf16 is read as it is; any other float dtype is first
        cast to bf16 here.
      sidx: [M] int32, contiguous; entries below 0 read row 0 and entries
        >= T read row T-1 (the reference's padding contract).

    Returns: [M, F] float32.
    """
    _check(table, sidx)
    if table.device.type == "cpu":
        return sorted_window_gather_plain(table, sidx)
    if table.device.type != "cuda":
        raise ValueError(f"no gather kernel for device {table.device}")
    from .build import load

    if table.dtype not in (torch.float32, torch.bfloat16):
        table = table.to(torch.bfloat16)
    T, F = table.shape
    M = sidx.shape[0]
    out = torch.empty((M, F), dtype=torch.float32, device=table.device)
    if M == 0:
        return out
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = load("sorted_gather").sorted_window_gather(
            table.data_ptr(), sidx.data_ptr(), out.data_ptr(), M, T, F,
            int(table.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"sorted_window_gather launch failed: CUDA error {rc}")
    sorted_window_gather.launches += 1
    return out


sorted_window_gather.launches = 0
