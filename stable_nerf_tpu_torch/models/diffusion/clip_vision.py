"""CLIP vision transformer, the image encoder (counterpart of
stable_nerf_tpu/models/diffusion/clip_vision.py).

The reference loads ``openai/clip-vit-large-patch14`` as a
CLIPVisionModelWithProjection and exposes ``clip_encode_images``
(reference stable_diffusion/network.py:29-31,182-189); the main train path
does not call it.  HF's semantics: patch convolution → [class] token +
position embeddings → pre-LayerNorm → encoder (non-causal attention,
quick_gelu) → post-LayerNorm of the class token → visual projection.  The
reference's image processor is a bilinear resize to the encoder's input
size (network.py:31): ``clip_resize``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch
import torch.nn.functional as F

from ...utils.device import resolve_device
from .clip_text import _act, _layer_norm, _linear


@dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    projection_dim: int = 768
    hidden_act: str = "quick_gelu"

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


def clip_vit_l14_config() -> CLIPVisionConfig:
    return CLIPVisionConfig()


def clip_vision_init(seed: int, cfg: CLIPVisionConfig, dtype=torch.float32, *,
                     device=None) -> Dict:
    """Random params from ``seed`` on ``device`` (default cuda)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    d, ff = cfg.hidden_size, cfg.intermediate_size

    def normal(*shape):
        return torch.randn(shape, generator=g, device=dev, dtype=dtype) * 0.02

    def lin(din, dout):
        return {"kernel": normal(din, dout), "bias": torch.zeros(dout, dtype=dtype, device=dev)}

    def ln():
        return {"scale": torch.ones(d, dtype=dtype, device=dev),
                "bias": torch.zeros(d, dtype=dtype, device=dev)}

    layers = [{"ln1": ln(), "q": lin(d, d), "k": lin(d, d), "v": lin(d, d),
               "out": lin(d, d), "ln2": ln(), "fc1": lin(d, ff), "fc2": lin(ff, d)}
              for _ in range(cfg.num_layers)]
    return {"patch_embedding": normal(d, 3, cfg.patch_size, cfg.patch_size),
            "class_embedding": normal(d),
            "position_embedding": normal(cfg.num_patches + 1, d),
            "pre_ln": ln(), "layers": layers, "post_ln": ln(),
            "visual_projection": normal(d, cfg.projection_dim)}


def clip_vision_params_from_hf(state_dict, cfg: CLIPVisionConfig, *, device=None) -> Dict:
    """A torch CLIPVisionModelWithProjection state dict → the port's tree,
    float32 on ``device`` (None: where the state dict's tensors are)."""
    def t(name):
        return torch.as_tensor(state_dict[name]).detach().to(device=device,
                                                             dtype=torch.float32)

    def lin(prefix):
        return {"kernel": t(prefix + ".weight").T, "bias": t(prefix + ".bias")}

    def ln(prefix):
        return {"scale": t(prefix + ".weight"), "bias": t(prefix + ".bias")}

    p = "vision_model."
    layers = []
    for i in range(cfg.num_layers):
        lp = f"{p}encoder.layers.{i}."
        layers.append({"ln1": ln(lp + "layer_norm1"), "q": lin(lp + "self_attn.q_proj"),
                       "k": lin(lp + "self_attn.k_proj"), "v": lin(lp + "self_attn.v_proj"),
                       "out": lin(lp + "self_attn.out_proj"), "ln2": ln(lp + "layer_norm2"),
                       "fc1": lin(lp + "mlp.fc1"), "fc2": lin(lp + "mlp.fc2")})
    params = {"patch_embedding": t(p + "embeddings.patch_embedding.weight"),
              "class_embedding": t(p + "embeddings.class_embedding"),
              "position_embedding": t(p + "embeddings.position_embedding.weight"),
              "pre_ln": ln(p + "pre_layrnorm"),     # (sic: HF's spelling)
              "layers": layers, "post_ln": ln(p + "post_layernorm")}
    if "visual_projection.weight" in state_dict:
        params["visual_projection"] = t("visual_projection.weight").T
    return params


def clip_vision_apply(params: Dict, pixel_values: torch.Tensor,
                      cfg: CLIPVisionConfig) -> Dict[str, torch.Tensor]:
    """pixel_values [B, 3, H, W] (CLIP-normalized) → last_hidden_state
    [B, 1 + P, d], pooled [B, d] and, with a projection, image_embeds
    [B, projection]."""
    B, d = pixel_values.shape[0], cfg.hidden_size
    h = F.conv2d(pixel_values, params["patch_embedding"], stride=cfg.patch_size)
    h = h.reshape(B, d, -1).transpose(1, 2)                  # [B, P², d], no bias
    cls = params["class_embedding"].expand(B, 1, d)
    x = torch.cat([cls, h], dim=1) + params["position_embedding"][None]
    x = _layer_norm(params["pre_ln"], x)
    nh = cfg.num_heads
    hd = d // nh
    for layer in params["layers"]:
        y = _layer_norm(layer["ln1"], x)

        def proj(p):
            return _linear(p, y).reshape(B, -1, nh, hd).transpose(1, 2)

        q = proj(layer["q"]) * (hd ** -0.5)
        a = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", q, proj(layer["k"])), dim=-1)
        o = torch.einsum("bhqk,bhkd->bhqd", a, proj(layer["v"])).transpose(1, 2)
        x = x + _linear(layer["out"], o.reshape(B, -1, d))
        y = _act(cfg.hidden_act, _linear(layer["fc1"], _layer_norm(layer["ln2"], x)))
        x = x + _linear(layer["fc2"], y)
    pooled = _layer_norm(params["post_ln"], x[:, 0])
    out = {"last_hidden_state": x, "pooled": pooled}
    if "visual_projection" in params:
        out["image_embeds"] = pooled @ params["visual_projection"]
    return out


def clip_resize(images: torch.Tensor, size: int) -> torch.Tensor:
    """Bilinear resize to the encoder's input size, antialiased when
    shrinking (the reference's whole image processor, network.py:31)."""
    return F.interpolate(images, size=(size, size), mode="bilinear", align_corners=False,
                         antialias=True)


def clip_encode_images(params: Dict, images: torch.Tensor,
                       cfg: CLIPVisionConfig) -> torch.Tensor:
    """The reference's SDNetwork.clip_encode_images (network.py:182-189):
    resize where needed, then the projected image embeds."""
    if images.shape[-1] != cfg.image_size or images.shape[-2] != cfg.image_size:
        images = clip_resize(images, cfg.image_size)
    return clip_vision_apply(params, images, cfg)["image_embeds"]
