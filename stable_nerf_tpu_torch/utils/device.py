"""Device policy of the port's entry points."""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch

_CONSTANTS: Dict = {}


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Raises when CUDA is asked for and no card is present; there is
    no quiet fall back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def disable_tf32() -> None:
    """Keep float32 matrix products and convolutions in full float32.

    cuDNN runs float32 convolutions in TF32 by default (about three
    decimal digits); the VAE encode and the parity checks compute in
    float32, so both switches are turned off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def device_constant(values: Union[float, Sequence[float]], device: torch.device) -> torch.Tensor:
    """``torch.tensor(values, dtype=torch.float32, device=device)``, made
    once per (values, device) and kept.  A tensor made from Python numbers
    on a card is copied from pageable memory, which waits for the stream,
    and cannot be made while a CUDA graph is being captured; the kept one
    is made at its first use.  Callers must not write to it."""
    key = (tuple(values) if isinstance(values, (list, tuple)) else values, torch.device(device))
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.tensor(values, dtype=torch.float32, device=device)
    return t
