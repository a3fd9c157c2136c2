"""CLIP text transformers, SDXL's two text encoders (counterpart of
stable_nerf_tpu/models/diffusion/clip_text.py).

The reference encodes one prompt, the empty string, once at init to cache
SDXL's conditioning (reference stable_diffusion/network.py:114-168 →
utils/sd_utils.py:133-340).  This module holds the whole text stack:

  * CLIP-L/14 (``text_encoder``: 12 layers, d = 768, quick_gelu, pads with
    eos) and OpenCLIP bigG (``text_encoder_2``: 32 layers, d = 1280, gelu,
    a text projection without bias, pads with 0);
  * ``encode_prompt_sdxl``: the two encoders' penultimate hidden states
    concatenated → [B, 77, 2048], and encoder 2's projected pooled output
    → [B, 1280], pooled at the first eos token (HF's semantics);
  * HF weight conversion (``params_from_hf_state_dict``, strict);
  * the empty prompt's token ids, hard-coded ([bos, eos, pad × 75]), so no
    tokenizer file is needed.

The attention is a plain einsum and softmax at 77 tokens; the reference
has no kernel here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...utils.device import resolve_device


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_positions: int = 77
    hidden_act: str = "quick_gelu"
    projection_dim: int = 0            # > 0: a text_projection head (encoder 2)
    bos_token_id: int = 49406
    eos_token_id: int = 49407
    pad_token_id: int = 49407          # CLIP-L pads with eos; bigG pads with 0


def clip_l_config() -> CLIPTextConfig:
    """openai/clip-vit-large-patch14's text tower (SDXL text_encoder)."""
    return CLIPTextConfig()


def open_clip_bigg_config() -> CLIPTextConfig:
    """laion OpenCLIP bigG's text tower (SDXL text_encoder_2)."""
    return CLIPTextConfig(hidden_size=1280, num_layers=32, num_heads=20,
                          intermediate_size=5120, hidden_act="gelu", projection_dim=1280,
                          pad_token_id=0)


def empty_prompt_ids(cfg: CLIPTextConfig, batch: int = 1) -> torch.Tensor:
    """Token ids of "": [bos, eos, pad × 75], int64 on the CPU."""
    ids = np.full((batch, cfg.max_positions), cfg.pad_token_id, np.int64)
    ids[:, 0] = cfg.bos_token_id
    ids[:, 1] = cfg.eos_token_id
    return torch.from_numpy(ids)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def clip_text_init(seed: int, cfg: CLIPTextConfig, dtype=torch.float32, *,
                   device=None) -> Dict:
    """Random params from ``seed`` on ``device`` (default cuda), in the tree
    that ``params_from_hf_state_dict`` builds (tests and synthetic
    checkpoints; real use loads pretrained weights)."""
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
    params = {"token_embedding": normal(cfg.vocab_size, d),
              "position_embedding": normal(cfg.max_positions, d),
              "layers": layers, "final_ln": ln()}
    if cfg.projection_dim:
        params["text_projection"] = normal(d, cfg.projection_dim)
    return params


def params_from_hf_state_dict(state_dict, cfg: CLIPTextConfig, strict: bool = False, *,
                              device=None) -> Dict:
    """A torch CLIPTextModel(WithProjection) state dict → the port's tree,
    float32 on ``device`` (None: where the state dict's tensors are).

    Linear weights are transposed ([out, in] → [in, out]).  ``strict``
    asserts that every checkpoint key was consumed (``position_ids``
    buffers of older transformers versions and ``logit_scale`` are
    ignored)."""
    used = set()

    def t(name):
        used.add(name)
        return torch.as_tensor(state_dict[name]).detach().to(device=device,
                                                             dtype=torch.float32)

    def lin(prefix):
        return {"kernel": t(prefix + ".weight").T, "bias": t(prefix + ".bias")}

    def ln(prefix):
        return {"scale": t(prefix + ".weight"), "bias": t(prefix + ".bias")}

    p = "text_model."
    layers = []
    for i in range(cfg.num_layers):
        lp = f"{p}encoder.layers.{i}."
        layers.append({"ln1": ln(lp + "layer_norm1"), "q": lin(lp + "self_attn.q_proj"),
                       "k": lin(lp + "self_attn.k_proj"), "v": lin(lp + "self_attn.v_proj"),
                       "out": lin(lp + "self_attn.out_proj"), "ln2": ln(lp + "layer_norm2"),
                       "fc1": lin(lp + "mlp.fc1"), "fc2": lin(lp + "mlp.fc2")})
    params = {"token_embedding": t(p + "embeddings.token_embedding.weight"),
              "position_embedding": t(p + "embeddings.position_embedding.weight"),
              "layers": layers, "final_ln": ln(p + "final_layer_norm")}
    if cfg.projection_dim and "text_projection.weight" in state_dict:
        params["text_projection"] = t("text_projection.weight").T
    if strict:
        unused = {k for k in state_dict if k not in used
                  and not k.endswith("position_ids") and k != "logit_scale"}
        if unused:
            raise ValueError(
                f"CLIP text: {len(unused)} checkpoint key(s) not consumed — "
                f"config/naming mismatch? e.g. {sorted(unused)[:10]}")
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _layer_norm(p, x, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], eps)


def _act(name, x):
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    return F.gelu(x)


def _linear(p, x):
    return x @ p["kernel"] + p["bias"]


def _attn(layer, x, cfg: CLIPTextConfig, bias):
    B, S, d = x.shape
    h = cfg.num_heads
    hd = d // h

    def proj(p):
        return _linear(p, x).reshape(B, S, h, hd).transpose(1, 2)

    q = proj(layer["q"]) * (hd ** -0.5)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, proj(layer["k"]))
    if bias is not None:
        logits = logits + bias
    o = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, dim=-1), proj(layer["v"]))
    return _linear(layer["out"], o.transpose(1, 2).reshape(B, S, d))


def clip_text_apply(params: Dict, input_ids, cfg: CLIPTextConfig) -> Dict[str, torch.Tensor]:
    """Run the text transformer on ``input_ids`` [B, S] (moved to the
    params' device).

    Returns:
      last_hidden_state: [B, S, d] after the final LayerNorm;
      penultimate: [B, S, d] the hidden state entering the last layer
        (HF's hidden_states[-2], without the final LayerNorm): what SDXL's
        conditioning uses;
      pooled: [B, d] the last hidden state at the first eos token, then
        the text projection where the params have one → [B, projection].
    """
    emb = params["token_embedding"]
    ids = torch.as_tensor(input_ids, device=emb.device).long()
    B, S = ids.shape
    x = emb[ids] + params["position_embedding"][:S]
    causal = torch.full((S, S), -math.inf, device=emb.device, dtype=x.dtype).triu(1)
    hidden_states = [x]
    for layer in params["layers"]:
        x = x + _attn(layer, _layer_norm(layer["ln1"], x), cfg, causal)
        y = _act(cfg.hidden_act, _linear(layer["fc1"], _layer_norm(layer["ln2"], x)))
        x = x + _linear(layer["fc2"], y)
        hidden_states.append(x)
    last = _layer_norm(params["final_ln"], x)
    # the FIRST eos token (torch.argmax returns the first maximum)
    eos_pos = torch.argmax((ids == cfg.eos_token_id).int(), dim=-1)
    pooled = last[torch.arange(B, device=emb.device), eos_pos]
    if "text_projection" in params:
        pooled = pooled @ params["text_projection"]
    return {"last_hidden_state": last, "penultimate": hidden_states[-2], "pooled": pooled}


def encode_prompt_sdxl(params_1: Dict, params_2: Dict, ids_1, ids_2,
                       cfg_1: CLIPTextConfig = None,
                       cfg_2: CLIPTextConfig = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """SDXL's dual-encoder prompt embedding (reference utils/sd_utils.py:
    133-340): both penultimate hidden states concatenated on the feature
    axis; the pooled embedding from encoder 2's projection.

    Returns (prompt_embeds [B, 77, 2048], pooled_embeds [B, 1280])."""
    out_1 = clip_text_apply(params_1, ids_1, cfg_1 or clip_l_config())
    out_2 = clip_text_apply(params_2, ids_2, cfg_2 or open_clip_bigg_config())
    return torch.cat([out_1["penultimate"], out_2["penultimate"]], dim=-1), out_2["pooled"]


def encode_prompt(params_1: Dict, params_2: Dict, ids_1, ids_2, neg_ids_1, neg_ids_2,
                  cfg_1: CLIPTextConfig = None, cfg_2: CLIPTextConfig = None):
    """The reference's prompt encoding with classifier-free guidance
    (utils/sd_utils.py:133-340): (prompt_embeds, negative_prompt_embeds,
    pooled, negative_pooled), the 4-tuple of reference
    stable_diffusion/network.py:118-134."""
    pe, pp = encode_prompt_sdxl(params_1, params_2, ids_1, ids_2, cfg_1, cfg_2)
    ne, np_ = encode_prompt_sdxl(params_1, params_2, neg_ids_1, neg_ids_2, cfg_1, cfg_2)
    return pe, ne, pp, np_


@torch.no_grad()
def make_empty_prompt_conditioning(params_1: Dict, params_2: Dict,
                                   cfg_1: CLIPTextConfig = None,
                                   cfg_2: CLIPTextConfig = None, resolution: int = 1024):
    """The empty prompt's SDXL conditioning, computed once as the reference
    does at init (stable_diffusion/network.py:114-168): the pooled embeds
    become ``add_text_embeds``; ``add_time_ids`` packs (original size,
    crop top-left, target size) at ``resolution``.

    Returns (prompt_embeds [1, 77, 2048], add_text_embeds [1, 1280],
    add_time_ids [1, 6]) on the params' device."""
    cfg_1 = cfg_1 or clip_l_config()
    cfg_2 = cfg_2 or open_clip_bigg_config()
    prompt_embeds, pooled = encode_prompt_sdxl(params_1, params_2, empty_prompt_ids(cfg_1),
                                               empty_prompt_ids(cfg_2), cfg_1, cfg_2)
    r = float(resolution)
    add_time_ids = torch.tensor([[r, r, 0.0, 0.0, r, r]], dtype=torch.float32,
                                device=pooled.device)
    return prompt_embeds, pooled, add_time_ids
