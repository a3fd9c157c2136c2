"""SDNetwork: the assembled SDXL + IP-Adapter stack (counterpart of
stable_nerf_tpu/models/diffusion/sd_network.py).

Params are one dict tree; ``trainable_mask`` marks the reference's
optimized subset (train.py:179-182): image_proj, downsampling and every
to_k_ip/to_v_ip.  Everything else is frozen pretrained weight.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from ...config import SchedulerConfig, SDConfig
from ...utils.device import resolve_device
from ...utils.tree import tree_map
from .ip_adapter import (downsampling_layers_apply, downsampling_layers_init,
                         image_proj_apply, image_proj_init)
from .unet import UNetConfig, sdxl_unet_config, unet_apply, unet_init
from .vae import (VAEConfig, vae_decode, vae_encode_mode, vae_encode_sample,
                  vae_init)


@dataclass(frozen=True)
class SDNetworkConfig:
    sd: SDConfig = field(default_factory=SDConfig)
    unet: UNetConfig = field(default_factory=sdxl_unet_config)
    vae: VAEConfig = field(default_factory=VAEConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)

    @property
    def proj_dim(self) -> int:
        """IP image-embed width entering ImageProjModel: 64·(latent/16)²
        after the CNN, else cond_channels·latent²."""
        if self.sd.use_downsampling_layers:
            return 64 * max(self.sd.latent_size // 16, 1) ** 2
        return self.sd.cond_channels * self.sd.latent_size ** 2


def sd_network_init(seed: int, cfg: SDNetworkConfig = SDNetworkConfig(), *,
                    device: Optional[torch.device] = None,
                    add_text_embeds=None, add_time_ids=None) -> Dict:
    """Random params from ``seed`` on ``device`` (default cuda).

    add_text_embeds / add_time_ids: the cached empty-prompt conditioning;
    defaults are zero pooled embeds and the SDXL time ids
    [1024, 1024, 0, 0, 1024, 1024]."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    params = {
        "vae": vae_init(g, cfg.vae),
        "unet": unet_init(g, cfg.unet, with_ip=True),
        "image_proj": image_proj_init(g, cfg.proj_dim, cfg.unet.cross_attention_dim,
                                      cfg.sd.num_tokens),
    }
    if cfg.sd.use_downsampling_layers:
        params["downsampling"] = downsampling_layers_init(g, cfg.sd.cond_channels)
    if add_text_embeds is None:
        add_text_embeds = torch.zeros((1, cfg.unet.pooled_projection_dim))
    if add_time_ids is None:
        add_time_ids = torch.tensor([[1024.0, 1024.0, 0.0, 0.0, 1024.0, 1024.0]])
    params["add_text_embeds"] = torch.as_tensor(add_text_embeds, dtype=torch.float32,
                                                device=dev)
    params["add_time_ids"] = torch.as_tensor(add_time_ids, dtype=torch.float32,
                                             device=dev)
    return params


def init_ip_from_unet(params: Dict) -> Dict:
    """Copy each cross-attention's to_k/to_v into fresh to_k_ip/to_v_ip
    tensors — the reference's IP weight init (network.py:104-110)."""

    def visit(tree):
        if isinstance(tree, dict):
            if "to_k_ip" in tree and "to_k" in tree:
                tree = dict(tree)
                tree["to_k_ip"] = tree_map(torch.clone, tree["to_k"])
                tree["to_v_ip"] = tree_map(torch.clone, tree["to_v"])
                return tree
            return {k: visit(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [visit(v) for v in tree]
        return tree

    return {**params, "unet": visit(params["unet"])}


def trainable_mask(params: Dict) -> Dict:
    """Bool tree: True on image_proj, downsampling and all to_*_ip."""

    def unet_mask(tree, inside_ip=False):
        if isinstance(tree, dict):
            return {k: unet_mask(v, inside_ip or k in ("to_k_ip", "to_v_ip"))
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [unet_mask(v, inside_ip) for v in tree]
        return inside_ip

    mask = {}
    for k, v in params.items():
        if k in ("image_proj", "downsampling"):
            mask[k] = tree_map(lambda _: True, v)
        elif k == "unet":
            mask[k] = unet_mask(v)
        else:
            mask[k] = tree_map(lambda _: False, v)
    return mask


def encode_images(params: Dict, images, cfg: SDNetworkConfig = SDNetworkConfig(), *,
                  eps=None, generator=None):
    """images [B, 3, H, W] in [-1, 1] → scaled latents (latent_dist.sample()
    with the normal draw ``eps`` given or drawn from ``generator``)."""
    return vae_encode_sample(params["vae"], images, cfg.vae, eps=eps,
                             generator=generator)


def encode_images_mode(params: Dict, images, cfg: SDNetworkConfig = SDNetworkConfig()):
    return vae_encode_mode(params["vae"], images, cfg.vae)


def decode_latents(params: Dict, latents, cfg: SDNetworkConfig = SDNetworkConfig()):
    """Scaled latents → images."""
    return vae_decode(params["vae"], latents, cfg.vae)


def embed_conditions(params: Dict, image_embeds, cfg: SDNetworkConfig = SDNetworkConfig(),
                     views_per_sample: int = 2):
    """[B·views, cond_channels, latent, latent] → [B, views·tokens, D]."""
    x = image_embeds
    if "downsampling" in params:
        x = downsampling_layers_apply(params["downsampling"], x)
    bs = x.shape[0] // views_per_sample
    tokens = image_proj_apply(params["image_proj"], x.reshape(x.shape[0], -1))
    return tokens.reshape(bs, views_per_sample * cfg.sd.num_tokens, -1)


def sd_forward(params: Dict, noisy_latents, timesteps, image_embeds,
               cfg: SDNetworkConfig = SDNetworkConfig(), *,
               compute_dtype=torch.float32, capture_ip_attn_maps: bool = False):
    """Noise prediction conditioned only on the ip tokens (reference
    SDNetwork.forward, network.py:191-212).

    capture_ip_attn_maps: also return the ip-stream attention maps; the
      return becomes ``(noise_pred, [maps...])``."""
    ip_tokens = embed_conditions(params, image_embeds, cfg)
    B = noisy_latents.shape[0]
    te = params["add_text_embeds"]
    out = unet_apply(
        params["unet"], noisy_latents, timesteps, ip_tokens,
        added_text_embeds=te.expand(B, te.shape[-1]),
        added_time_ids=params["add_time_ids"].expand(B, 6),
        cfg=cfg.unet, compute_dtype=compute_dtype,
        capture_ip_attn_maps=capture_ip_attn_maps)
    if capture_ip_attn_maps:
        eps, aux = out
        return eps, aux["ip_attn_maps"]
    return out
