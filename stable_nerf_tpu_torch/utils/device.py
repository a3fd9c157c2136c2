"""Device policy of the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


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
