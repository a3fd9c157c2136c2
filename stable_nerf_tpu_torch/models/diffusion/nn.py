"""Functional NN primitives of the diffusion models (counterpart of
stable_nerf_tpu/models/diffusion/nn.py).

Param layout, kept from the reference package:
  conv:   {"kernel": [O, I, kh, kw], "bias": [O]}   (OIHW)
  linear: {"kernel": [in, out], "bias": [out]?}
  norm:   {"scale": [C], "bias": [C]}
Activations are NCHW.  A weight is cast to the activation's dtype at use,
so frozen weights may be stored in bf16 while an f32 path (the VAE
encode) still computes in f32.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F


def uniform(generator: torch.Generator, shape, scale: float) -> torch.Tensor:
    """U(-scale, scale) float32 tensor on the generator's device.  A
    generator on the ``meta`` device (``META_GENERATOR``) draws nothing:
    the result only has the shape, as a template needs."""
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    if t.is_meta:
        return t
    return t.uniform_(-scale, scale, generator=generator)


class _MetaGenerator:
    """Stands for a ``torch.Generator`` in the init functions, which read
    only its ``device``: they then build shape-only trees at no memory."""

    device = torch.device("meta")


META_GENERATOR = _MetaGenerator()


def conv2d(p: Dict, x: torch.Tensor, stride: int = 1, padding: int = 1) -> torch.Tensor:
    bias = p["bias"].to(x.dtype) if "bias" in p else None
    return F.conv2d(x, p["kernel"].to(x.dtype), bias, stride=stride, padding=padding)


def linear(p: Dict, x: torch.Tensor) -> torch.Tensor:
    out = x @ p["kernel"].to(x.dtype)
    if "bias" in p:
        out = out + p["bias"].to(x.dtype)
    return out


def group_norm(p: Dict, x: torch.Tensor, groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm over NCHW with float32 statistics and affine, cast back to
    the input's dtype."""
    xf = F.group_norm(x.float(), groups, eps=eps)
    out = xf * p["scale"][None, :, None, None] + p["bias"][None, :, None, None]
    return out.to(x.dtype)


def layer_norm(p: Dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = F.layer_norm(x.float(), (x.shape[-1],), eps=eps)
    return (xf * p["scale"] + p["bias"]).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Scaled dot-product attention over [B, H, S, D].

    Logits are float32 whatever the input type: for bf16 inputs the scaled
    q is rounded to bf16 and the products of the bf16 operands are summed
    in f32 (the reference's preferred_element_type=float32); the softmax is
    f32 and the probabilities are cast to v's dtype for the second
    product."""
    scale = q.shape[-1] ** -0.5
    if q.dtype == torch.bfloat16:
        qs = (q * scale).to(q.dtype).float()
    else:
        qs = q.float() * scale
    logits = qs @ k.float().transpose(-1, -2)
    attn = torch.softmax(logits, dim=-1)
    return attn.to(v.dtype) @ v


def split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.reshape(b, s, n_heads, d // n_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, hd = x.shape
    return x.transpose(1, 2).reshape(b, s, h * hd)


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: float = 10000.0,
                       flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0) -> torch.Tensor:
    """Sinusoidal timestep embedding (diffusers get_timestep_embedding)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    freqs = torch.exp(exponent / (half - downscale_freq_shift))
    args = timesteps.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
