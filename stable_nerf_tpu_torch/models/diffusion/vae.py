"""SDXL AutoencoderKL (counterpart of
stable_nerf_tpu/models/diffusion/vae.py).

Encode and decode compute in their input's dtype (float32 in the joint
and inference steps) whatever the storage dtype of the weights.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .nn import conv2d, group_norm, sdpa, silu, uniform


@dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_groups: int = 32
    scaling_factor: float = 0.13025


def _conv(g, ci, co, ksz):
    dev = g.device
    return {"kernel": uniform(g, (co, ci, ksz, ksz), 1.0 / math.sqrt(ci * ksz * ksz)),
            "bias": torch.zeros(co, device=dev)}


def _norm(c, dev):
    return {"scale": torch.ones(c, device=dev), "bias": torch.zeros(c, device=dev)}


def _resnet_init(g, cin, cout):
    p = {"norm1": _norm(cin, g.device), "conv1": _conv(g, cin, cout, 3),
         "norm2": _norm(cout, g.device), "conv2": _conv(g, cout, cout, 3)}
    if cin != cout:
        p["conv_shortcut"] = _conv(g, cin, cout, 1)
    return p


def _resnet_apply(p, x, groups):
    h = conv2d(p["conv1"], silu(group_norm(p["norm1"], x, groups)))
    h = conv2d(p["conv2"], silu(group_norm(p["norm2"], h, groups)))
    if "conv_shortcut" in p:
        x = conv2d(p["conv_shortcut"], x, padding=0)
    return x + h


def _attn_init(g, c):
    def lin():   # stored [out, in], applied as y @ kernel.T (diffusers layout)
        return {"kernel": uniform(g, (c, c), 1.0 / math.sqrt(c)),
                "bias": torch.zeros(c, device=g.device)}

    return {"group_norm": _norm(c, g.device), "to_q": lin(), "to_k": lin(),
            "to_v": lin(), "to_out": lin()}


def _attn_apply(p, x, groups):
    """Single-head spatial self-attention (diffusers VAE mid-block)."""
    n, c, h, w = x.shape
    y = group_norm(p["group_norm"], x, groups).reshape(n, c, h * w).transpose(1, 2)

    def proj(q):
        return y @ q["kernel"].T.to(y.dtype) + q["bias"].to(y.dtype)

    o = sdpa(proj(p["to_q"])[:, None], proj(p["to_k"])[:, None],
             proj(p["to_v"])[:, None])[:, 0]
    o = o @ p["to_out"]["kernel"].T.to(y.dtype) + p["to_out"]["bias"].to(y.dtype)
    return x + o.transpose(1, 2).reshape(n, c, h, w)


def _mid_init(g, c):
    # the reference draws resnet 0, attention, resnet 1 from separate keys;
    # the order here only fixes which random numbers go where
    r0, a, r1 = _resnet_init(g, c, c), _attn_init(g, c), _resnet_init(g, c, c)
    return {"resnets": [r0, r1], "attentions": [a]}


def _mid_apply(p, x, groups):
    x = _resnet_apply(p["resnets"][0], x, groups)
    x = _attn_apply(p["attentions"][0], x, groups)
    return _resnet_apply(p["resnets"][1], x, groups)


def vae_init(generator: torch.Generator, cfg: VAEConfig = VAEConfig()) -> Dict:
    """Random params with the converted-checkpoint tree structure, on the
    generator's device."""
    g = generator
    ch = cfg.block_out_channels
    enc_blocks, cin = [], ch[0]
    for i, c in enumerate(ch):
        block = {"resnets": [_resnet_init(g, cin if j == 0 else c, c)
                             for j in range(cfg.layers_per_block)]}
        if i < len(ch) - 1:
            block["downsample"] = _conv(g, c, c, 3)
        enc_blocks.append(block)
        cin = c
    dec_ch = tuple(reversed(ch))
    dec_blocks, cin = [], dec_ch[0]
    for i, c in enumerate(dec_ch):
        block = {"resnets": [_resnet_init(g, cin if j == 0 else c, c)
                             for j in range(cfg.layers_per_block + 1)]}
        if i < len(dec_ch) - 1:
            block["upsample"] = _conv(g, c, c, 3)
        dec_blocks.append(block)
        cin = c
    lc = cfg.latent_channels
    return {
        "encoder": {
            "conv_in": _conv(g, cfg.in_channels, ch[0], 3),
            "down_blocks": enc_blocks,
            "mid": _mid_init(g, ch[-1]),
            "norm_out": _norm(ch[-1], g.device),
            "conv_out": _conv(g, ch[-1], 2 * lc, 3),
        },
        "quant_conv": _conv(g, 2 * lc, 2 * lc, 1),
        "post_quant_conv": _conv(g, lc, lc, 1),
        "decoder": {
            "conv_in": _conv(g, lc, dec_ch[0], 3),
            "mid": _mid_init(g, dec_ch[0]),
            "up_blocks": dec_blocks,
            "norm_out": _norm(dec_ch[-1], g.device),
            "conv_out": _conv(g, dec_ch[-1], cfg.in_channels, 3),
        },
    }


def vae_encode_moments(params: Dict, x: torch.Tensor, cfg: VAEConfig = VAEConfig()):
    """images [N, 3, H, W] in [-1, 1] → (mean, logvar) each [N, 4, H/8, W/8]."""
    gr = cfg.norm_groups
    e = params["encoder"]
    h = conv2d(e["conv_in"], x)
    for block in e["down_blocks"]:
        for r in block["resnets"]:
            h = _resnet_apply(r, h, gr)
        if "downsample" in block:
            # diffusers pads (0, 1, 0, 1), then strides 2 with no padding
            h = conv2d(block["downsample"], F.pad(h, (0, 1, 0, 1)), stride=2, padding=0)
    h = _mid_apply(e["mid"], h, gr)
    h = conv2d(e["conv_out"], silu(group_norm(e["norm_out"], h, gr)))
    mean, logvar = conv2d(params["quant_conv"], h, padding=0).chunk(2, dim=1)
    return mean, torch.clamp(logvar, -30.0, 20.0)


def vae_encode_sample(params: Dict, x: torch.Tensor, cfg: VAEConfig = VAEConfig(), *,
                      eps: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """z = (mean + std·eps)·scaling_factor, with ``eps`` given or drawn
    standard normal from ``generator``."""
    mean, logvar = vae_encode_moments(params, x, cfg)
    if eps is None:
        eps = torch.randn(mean.shape, dtype=mean.dtype, device=mean.device,
                          generator=generator)
    return (mean + torch.exp(0.5 * logvar) * eps) * cfg.scaling_factor


def vae_encode_mode(params: Dict, x: torch.Tensor, cfg: VAEConfig = VAEConfig()):
    """Deterministic (mode) encode × scaling factor."""
    mean, _ = vae_encode_moments(params, x, cfg)
    return mean * cfg.scaling_factor


def vae_decode(params: Dict, z: torch.Tensor, cfg: VAEConfig = VAEConfig()) -> torch.Tensor:
    """Scaled latents [N, 4, h, w] → images [N, 3, 8h, 8w]."""
    gr = cfg.norm_groups
    d = params["decoder"]
    h = conv2d(params["post_quant_conv"], z / cfg.scaling_factor, padding=0)
    h = conv2d(d["conv_in"], h)
    h = _mid_apply(d["mid"], h, gr)
    for block in d["up_blocks"]:
        for r in block["resnets"]:
            h = _resnet_apply(r, h, gr)
        if "upsample" in block:
            h = conv2d(block["upsample"], F.interpolate(h, scale_factor=2,
                                                        mode="nearest"))
    return conv2d(d["conv_out"], silu(group_norm(d["norm_out"], h, gr)))
