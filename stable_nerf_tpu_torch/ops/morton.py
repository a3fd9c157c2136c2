"""Morton (Z-order) indexing and occupancy bitfield packing (counterpart of
stable_nerf_tpu/ops/morton.py; reference raymarching.cu:57-82, 268-301).

The occupancy grid is kept in linear (x·H² + y·H + z) order as a bool
tensor; these helpers exist for bit parity with the CUDA grid layout of
the reference.  PyTorch's ``uint32`` has few kernels, so the 32-bit
arithmetic runs in int64 and is masked to 32 bits after every multiply.
"""

from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    # reference raymarching.cu:57-64 (__expand_bits), 10-bit → every 3rd bit
    v = v.to(torch.int64) & _U32
    v = ((v * 0x00010001) & _U32) & 0xFF0000FF
    v = ((v * 0x00000101) & _U32) & 0x0F00F00F
    v = ((v * 0x00000011) & _U32) & 0xC30C30C3
    v = ((v * 0x00000005) & _U32) & 0x49249249
    return v


def _to_int32(v: torch.Tensor) -> torch.Tensor:
    """Reinterpret the low 32 bits of an int64 tensor as int32."""
    v = v & _U32
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def morton3d(coords: torch.Tensor) -> torch.Tensor:
    """coords [..., 3] int in [0, 1024) → Morton indices [...] int32:
    x | y<<1 | z<<2 (reference __morton3D)."""
    x = _expand_bits(coords[..., 0])
    y = _expand_bits(coords[..., 1])
    z = _expand_bits(coords[..., 2])
    return _to_int32(x | (y << 1) | (z << 2))


def _compact_bits(x: torch.Tensor) -> torch.Tensor:
    # reference raymarching.cu:74-82 (__morton3D_invert)
    x = x & 0x49249249
    x = (x | (x >> 2)) & 0xC30C30C3
    x = (x | (x >> 4)) & 0x0F00F00F
    x = (x | (x >> 8)) & 0xFF0000FF
    x = (x | (x >> 16)) & 0x0000FFFF
    return x


def morton3d_invert(indices: torch.Tensor) -> torch.Tensor:
    """Morton indices [...] int32 → coords [..., 3] int32."""
    ind = indices.to(torch.int64) & _U32
    return torch.stack([_compact_bits(ind >> s).to(torch.int32) for s in (0, 1, 2)],
                       dim=-1)


def packbits(grid: torch.Tensor, thresh) -> torch.Tensor:
    """Pack a float density grid [..., N] (N % 8 == 0) into [..., N // 8]
    uint8, bit i of byte k = grid[8k + i] > thresh (reference
    kernel_packbits)."""
    shape = grid.shape
    bits = (grid.reshape(shape[:-1] + (shape[-1] // 8, 8)) > thresh).to(torch.int32)
    weights = torch.tensor([1 << i for i in range(8)], dtype=torch.int32,
                           device=grid.device)
    return (bits * weights).sum(dim=-1).to(torch.uint8)


def unpackbits(bitfield: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`packbits`: [..., M] uint8 → [..., M·8] bool."""
    shifts = torch.arange(8, dtype=torch.int32, device=bitfield.device)
    bits = (bitfield.to(torch.int32)[..., None] >> shifts) & 1
    return bits.reshape(bitfield.shape[:-1] + (bitfield.shape[-1] * 8,)).bool()
