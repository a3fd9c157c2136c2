"""Precision of the plain reference: float32 everywhere (TF32 off), or the
control, one step below what a configuration states.

The control stands in the program's place to show that the comparison that
decides ``correct`` fails a lower precision:

* operands of matrix products and convolutions that the configuration runs
  in bfloat16 (the U-Net, the IP path, the NeRF MLPs) are rounded to fp8
  e4m3 with a per-tensor scale, the product summed in float32, as an fp8
  GEMM does;
* operands of the float32 convolutions with TF32 off (the VAE) are rounded
  to TF32 (10 mantissa bits), as TF32 tensor cores do;
* the float32 hash table is read rounded to bfloat16.

The rounding is emulated in float32 arithmetic, so it reads the same on
the CPU and on the card.
"""

from __future__ import annotations

import contextlib

import torch

_MODE = ["reference"]
FP8_MAX = 448.0


def mode() -> str:
    return _MODE[0]


@contextlib.contextmanager
def use(name: str):
    """Run the block with precision ``name`` ("reference" or "control")."""
    if name not in ("reference", "control"):
        raise ValueError(f"unknown precision {name!r}")
    old = _MODE[0]
    _MODE[0] = name
    try:
        yield
    finally:
        _MODE[0] = old


def _fp8(x: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        amax = x.abs().amax().clamp(min=1e-12)
        scale = FP8_MAX / amax
        q = (x * scale).to(torch.float8_e4m3fn).float() / scale
    # the rounding passes the gradient straight through, as in fp8 training
    return x + (q - x).detach()


def _tf32(x: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        bits = x.contiguous().view(torch.int32)
        q = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (q - x).detach()


def low(x: torch.Tensor) -> torch.Tensor:
    """An operand of a product the configuration runs in bfloat16."""
    x = x.float()
    return _fp8(x) if _MODE[0] == "control" else x


def full(x: torch.Tensor) -> torch.Tensor:
    """An operand of a product the configuration runs in float32, TF32 off."""
    x = x.float()
    return _tf32(x) if _MODE[0] == "control" else x


def table(x: torch.Tensor) -> torch.Tensor:
    """The float32 hash table as it is read."""
    return x.to(torch.bfloat16).float() if _MODE[0] == "control" else x
