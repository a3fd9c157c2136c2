"""IP-Adapter conditioning modules (counterpart of
stable_nerf_tpu/models/diffusion/ip_adapter.py): ImageProjModel
(Linear → reshape → LayerNorm) and the conditioning downsampling CNN
[B, 7, 64, 64] → [B, 64, 4, 4]."""

from __future__ import annotations

import math
from typing import Dict

import torch

from .nn import conv2d, linear, uniform


def image_proj_init(generator: torch.Generator, clip_embeddings_dim: int,
                    cross_attention_dim: int, num_tokens: int) -> Dict:
    dev = generator.device
    return {
        "proj": {
            "kernel": uniform(generator, (clip_embeddings_dim,
                                          num_tokens * cross_attention_dim),
                              1.0 / math.sqrt(clip_embeddings_dim)),
            "bias": torch.zeros(num_tokens * cross_attention_dim, device=dev),
        },
        "norm": {"scale": torch.ones(cross_attention_dim, device=dev),
                 "bias": torch.zeros(cross_attention_dim, device=dev)},
    }


def image_proj_apply(params: Dict, image_embeds: torch.Tensor) -> torch.Tensor:
    """[B, embed_dim] → [B, num_tokens, cross_attention_dim]; tokens and
    width come from the param shapes."""
    d = params["norm"]["scale"].shape[0]
    t = params["proj"]["kernel"].shape[1] // d
    x = linear(params["proj"], image_embeds).reshape(-1, t, d)
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + 1e-5)
    return x * params["norm"]["scale"] + params["norm"]["bias"]


def downsampling_layers_init(generator: torch.Generator, in_channels: int = 7) -> Dict:
    def conv(ci, co, ksz):
        return {"kernel": uniform(generator, (co, ci, ksz, ksz),
                                  1.0 / math.sqrt(ci * ksz * ksz)),
                "bias": torch.zeros(co, device=generator.device)}

    return {"conv1": conv(in_channels, 16, 4), "conv2": conv(16, 32, 4),
            "conv3": conv(32, 64, 4)}


def downsampling_layers_apply(params: Dict, x: torch.Tensor) -> torch.Tensor:
    x = torch.relu(conv2d(params["conv1"], x, stride=2, padding=1))
    x = torch.relu(conv2d(params["conv2"], x, stride=2, padding=1))
    return torch.relu(conv2d(params["conv3"], x, stride=4, padding=0))
