"""SDXL UNet2DConditionModel with native two-stream IP-Adapter
cross-attention (counterpart of stable_nerf_tpu/models/diffusion/unet.py).

A cross-attention whose params carry ``to_k_ip``/``to_v_ip`` splits its
conditioning sequence by position: the last ``ip_num_tokens`` tokens feed
the ip stream, the rest the "text" stream (attention_processor.py:349-397).
The joint step passes 2·num_tokens tokens (target view, then reference
view), so the text stream sees the target view's tokens — reproduced as is.

``tp_axis`` and ``sp_axis`` (axes of a ``parallel.sharding.Mesh``) run the
transformers tensor- and sequence-parallel: heads and the GEGLU width
split over the model axis (``parallel.tp``), latent tokens over the seq
axis with ring self-attention (``nn.ring_sdpa``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...parallel.tp import copy_to_model, gather_dim, reduce_from_model
from .nn import (conv2d, group_norm, layer_norm, linear, merge_heads, ring_sdpa, sdpa,
                 silu, split_heads, timestep_embedding, uniform)


@dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280)
    layers_per_block: int = 2
    # transformer depth per block (0 = plain ResNet block)
    transformer_layers: Tuple[int, ...] = (0, 2, 10)
    head_dim: int = 64
    cross_attention_dim: int = 2048
    norm_groups: int = 32
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816  # 1280 + 6·256
    pooled_projection_dim: int = 1280
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0
    ip_num_tokens: int = 2
    ip_scale: float = 1.0
    # recompute every resnet and transformer block in the backward pass
    # (torch.utils.checkpoint): about one more forward of work for none of
    # the blocks' inner activations held
    remat: bool = False

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


def sdxl_unet_config() -> UNetConfig:
    return UNetConfig()


def tiny_unet_config() -> UNetConfig:
    """CPU-testable reduction preserving every structural feature."""
    return UNetConfig(
        block_out_channels=(32, 64), transformer_layers=(0, 1), head_dim=8,
        cross_attention_dim=48, norm_groups=8, addition_time_embed_dim=16,
        projection_class_embeddings_input_dim=32 + 6 * 16,
        pooled_projection_dim=32,
    )


def demo_unet_config(num_tokens: int = 16) -> UNetConfig:
    """The learned-diffusion demo's U-Net, trained from scratch:
    cross-attention at both resolutions, wider channels than the tiny
    config, and ``num_tokens`` IP tokens a view at width 64, so that the
    2·num_tokens·64 conditioning values cover a 16×16×4 latent."""
    return UNetConfig(
        block_out_channels=(64, 128), transformer_layers=(1, 2), head_dim=8,
        cross_attention_dim=64, norm_groups=16, addition_time_embed_dim=16,
        projection_class_embeddings_input_dim=32 + 6 * 16,
        pooled_projection_dim=32, ip_num_tokens=num_tokens,
    )


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _lin_init(g, din, dout, bias=True):
    p = {"kernel": uniform(g, (din, dout), 1.0 / math.sqrt(din))}
    if bias:
        p["bias"] = torch.zeros(dout, device=g.device)
    return p


def _conv_init(g, cin, cout, k=3):
    return {"kernel": uniform(g, (cout, cin, k, k), 1.0 / math.sqrt(cin * k * k)),
            "bias": torch.zeros(cout, device=g.device)}


def _norm_init(c, dev):
    return {"scale": torch.ones(c, device=dev), "bias": torch.zeros(c, device=dev)}


def _resnet_init(g, cin, cout, temb_dim):
    p = {"norm1": _norm_init(cin, g.device), "conv1": _conv_init(g, cin, cout),
         "time_emb_proj": _lin_init(g, temb_dim, cout),
         "norm2": _norm_init(cout, g.device), "conv2": _conv_init(g, cout, cout)}
    if cin != cout:
        p["conv_shortcut"] = _conv_init(g, cin, cout, k=1)
    return p


def _attn_init(g, c, kv_dim, with_ip):
    p = {"to_q": _lin_init(g, c, c, bias=False),
         "to_k": _lin_init(g, kv_dim, c, bias=False),
         "to_v": _lin_init(g, kv_dim, c, bias=False),
         "to_out": _lin_init(g, c, c)}
    if with_ip:
        p["to_k_ip"] = _lin_init(g, kv_dim, c, bias=False)
        p["to_v_ip"] = _lin_init(g, kv_dim, c, bias=False)
    return p


def _tblock_init(g, c, cfg: UNetConfig, with_ip):
    return {"norm1": _norm_init(c, g.device), "attn1": _attn_init(g, c, c, False),
            "norm2": _norm_init(c, g.device),
            "attn2": _attn_init(g, c, cfg.cross_attention_dim, with_ip),
            "norm3": _norm_init(c, g.device),
            "ff_geglu": _lin_init(g, c, 8 * c), "ff_out": _lin_init(g, 4 * c, c)}


def _transformer_init(g, c, depth, cfg: UNetConfig, with_ip):
    return {"norm": _norm_init(c, g.device), "proj_in": _lin_init(g, c, c),
            "blocks": [_tblock_init(g, c, cfg, with_ip) for _ in range(depth)],
            "proj_out": _lin_init(g, c, c)}


def unet_init(generator: torch.Generator, cfg: UNetConfig = UNetConfig(),
              with_ip: bool = True) -> Dict:
    """Random params on the generator's device, in the reference's tree
    layout (diffusers key names)."""
    g = generator
    ch = cfg.block_out_channels
    ted = cfg.time_embed_dim
    params: Dict = {
        "conv_in": _conv_init(g, cfg.in_channels, ch[0]),
        "time_embedding": {"linear_1": _lin_init(g, ch[0], ted),
                           "linear_2": _lin_init(g, ted, ted)},
        "add_embedding": {
            "linear_1": _lin_init(g, cfg.projection_class_embeddings_input_dim, ted),
            "linear_2": _lin_init(g, ted, ted)},
    }
    down, cin = [], ch[0]
    for i, c in enumerate(ch):
        block = {"resnets": [], "attentions": []}
        for j in range(cfg.layers_per_block):
            block["resnets"].append(_resnet_init(g, cin if j == 0 else c, c, ted))
            if cfg.transformer_layers[i] > 0:
                block["attentions"].append(
                    _transformer_init(g, c, cfg.transformer_layers[i], cfg, with_ip))
        if i < len(ch) - 1:
            block["downsample"] = _conv_init(g, c, c)
        down.append(block)
        cin = c
    params["down_blocks"] = down
    params["mid_block"] = {
        "resnets": [_resnet_init(g, ch[-1], ch[-1], ted),
                    _resnet_init(g, ch[-1], ch[-1], ted)],
        "attentions": ([_transformer_init(g, ch[-1], cfg.transformer_layers[-1],
                                          cfg, with_ip)]
                       if cfg.transformer_layers[-1] > 0 else []),
    }
    up = []
    rev = tuple(reversed(ch))
    rev_tl = tuple(reversed(cfg.transformer_layers))
    for i, c in enumerate(rev):
        prev_out = rev[i - 1] if i > 0 else rev[0]
        block = {"resnets": [], "attentions": []}
        for j in range(cfg.layers_per_block + 1):
            skip_ch = rev[min(i + 1, len(rev) - 1)] if j == cfg.layers_per_block else c
            res_in = (prev_out if j == 0 else c) + skip_ch
            block["resnets"].append(_resnet_init(g, res_in, c, ted))
            if rev_tl[i] > 0:
                block["attentions"].append(_transformer_init(g, c, rev_tl[i], cfg,
                                                             with_ip))
        if i < len(rev) - 1:
            block["upsample"] = _conv_init(g, c, c)
        up.append(block)
    params["up_blocks"] = up
    params["conv_norm_out"] = _norm_init(ch[0], g.device)
    params["conv_out"] = _conv_init(g, ch[0], cfg.out_channels)
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _resnet(p, x, temb, groups):
    h = conv2d(p["conv1"], silu(group_norm(p["norm1"], x, groups, eps=1e-5)))
    h = h + linear(p["time_emb_proj"], silu(temb))[:, :, None, None]
    h = conv2d(p["conv2"], silu(group_norm(p["norm2"], h, groups, eps=1e-5)))
    if "conv_shortcut" in p:
        x = conv2d(p["conv_shortcut"], x, padding=0)
    return x + h


def _reduce_proj(p, x, tp_axis):
    """The output projection after a column-sharded block: the local
    product, summed over the model axis, the bias added once after the sum
    (megatron's row-parallel linear); ``linear`` without ``tp_axis``."""
    out = x @ p["kernel"].to(x.dtype)
    if tp_axis is not None:
        out = reduce_from_model(out, tp_axis)
    if "bias" in p:
        out = out + p["bias"].to(x.dtype)
    return out


def _attention(p, x, context, head_dim, ip_tokens: int, ip_scale: float,
               attn_maps=None, tp_axis=None, sp_axis=None):
    """Self-attention when ``context`` is None; else cross-attention, split
    into text and ip streams when the layer has ip weights.  When
    ``attn_maps`` is a list, the ip stream's float32 attention
    probabilities softmax(s·q·k_ipᵀ) [B, H, S, ip_tokens] are appended.

    The head count comes from the (possibly model-sharded) ``to_q`` width:
    under ``tp_axis`` each rank runs its head group and ``to_out`` sums the
    parts.  Under ``sp_axis`` ``x`` is this rank's token block:
    self-attention runs ``ring_sdpa``; cross-attention needs no collective
    (its k/v come from the replicated ``context``)."""
    n_heads = p["to_q"]["kernel"].shape[1] // head_dim
    if tp_axis is not None:
        x = copy_to_model(x, tp_axis)
        context = None if context is None else copy_to_model(context, tp_axis)
    q = split_heads(linear(p["to_q"], x), n_heads)

    def kv(k_p, v_p, ctx):
        return (split_heads(linear(k_p, ctx), n_heads),
                split_heads(linear(v_p, ctx), n_heads))

    if context is None:
        k, v = kv(p["to_k"], p["to_v"], x)
        out = merge_heads(ring_sdpa(q, k, v, sp_axis) if sp_axis is not None
                          else sdpa(q, k, v))
    elif "to_k_ip" in p and ip_tokens > 0:
        end = context.shape[1] - ip_tokens
        out = merge_heads(sdpa(q, *kv(p["to_k"], p["to_v"], context[:, :end])))
        k_ip, v_ip = kv(p["to_k_ip"], p["to_v_ip"], context[:, end:])
        out = out + ip_scale * merge_heads(sdpa(q, k_ip, v_ip))
        if attn_maps is not None:
            logits = (q * q.shape[-1] ** -0.5).float() @ k_ip.float().transpose(-1, -2)
            probs = torch.softmax(logits, dim=-1)
            if tp_axis is not None:         # the whole head axis
                probs = gather_dim(probs, tp_axis, 1)
            if sp_axis is not None:         # the whole query axis
                probs = gather_dim(probs, sp_axis, 2)
            attn_maps.append(probs)
    else:
        out = merge_heads(sdpa(q, *kv(p["to_k"], p["to_v"], context)))
    return _reduce_proj(p["to_out"], out, tp_axis)


def _transformer(p, x, context, cfg: UNetConfig, groups, attn_maps=None, tp_axis=None,
                 sp_axis=None):
    """Spatial transformer stack.  Under ``sp_axis`` its interior keeps only
    this rank's block of the h·w tokens (proj_in, the norms, GEGLU and the
    projections are per token; self-attention rotates k/v round the ring)
    and one gather after ``proj_out`` brings the whole token axis back."""
    n, c, h, w = x.shape
    y = group_norm(p["norm"], x, groups, eps=1e-6).reshape(n, c, h * w).transpose(1, 2)
    if sp_axis is not None:
        seq, sp = h * w, sp_axis.world
        if seq % sp:
            raise ValueError(f"sequence length {seq} ({h}x{w} latent tokens) not "
                             f"divisible by sequence-parallel axis size {sp}")
        y = y[:, sp_axis.rank * (seq // sp):(sp_axis.rank + 1) * (seq // sp)]
    y = linear(p["proj_in"], y)
    for blk in p["blocks"]:
        y = y + _attention(blk["attn1"], layer_norm(blk["norm1"], y), None,
                           cfg.head_dim, 0, 0.0, tp_axis=tp_axis, sp_axis=sp_axis)
        y = y + _attention(blk["attn2"], layer_norm(blk["norm2"], y), context,
                           cfg.head_dim, cfg.ip_num_tokens, cfg.ip_scale, attn_maps,
                           tp_axis=tp_axis, sp_axis=sp_axis)
        z = layer_norm(blk["norm3"], y)
        if tp_axis is not None:
            z = copy_to_model(z, tp_axis)
        # diffusers GEGLU order; under tp_axis the permuted local columns
        val, gate = linear(blk["ff_geglu"], z).chunk(2, dim=-1)
        y = y + _reduce_proj(blk["ff_out"], val * F.gelu(gate), tp_axis)  # exact erf GELU
    y = linear(p["proj_out"], y)
    if sp_axis is not None:
        y = gather_dim(y, sp_axis, 1)
    return x + y.transpose(1, 2).reshape(n, c, h, w)


def unet_apply(params: Dict, sample: torch.Tensor, timesteps, encoder_hidden_states,
               *, added_text_embeds, added_time_ids, cfg: UNetConfig = UNetConfig(),
               compute_dtype=torch.float32, capture_ip_attn_maps: bool = False,
               tp_axis=None, sp_axis=None):
    """Predict noise [B, 4, h, w] (float32) from noisy latents, timesteps
    (scalar or [B]), conditioning tokens [B, S, cross_attention_dim], the
    SDXL pooled text embeds [B, pooled] and time ids [B, 6].

    capture_ip_attn_maps: return ``(eps, {"ip_attn_maps": [...]})`` with
      every ip-stream cross-attention probability map [B, H, S, ip_tokens]
      in float32, outermost layer first.
    tp_axis: the model axis of a ``parallel.sharding.Mesh`` for megatron
      tensor parallelism: the params are this rank's slices
      (``parallel.tp.shard_unet_for_tp``, GEGLU permuted), the activations
      replicated, every rank of the axis calls this with the same inputs.
    sp_axis: the seq axis for sequence parallelism: params and inputs
      replicated over it, every transformer interior keeps h·w/n tokens a
      rank (ring self-attention, one gather a transformer).  Every token
      count the U-Net visits must divide by the axis size (ValueError
      otherwise).  Composes with ``tp_axis``; a serving lever, as in the JAX
      package (the replicated leaves' gradients would be each rank's
      tokens' part)."""
    gr = cfg.norm_groups
    B = sample.shape[0]
    x = sample.to(compute_dtype)
    context = encoder_hidden_states.to(compute_dtype)
    ts = torch.as_tensor(timesteps, device=sample.device).expand(B)
    temb = timestep_embedding(ts, cfg.block_out_channels[0],
                              flip_sin_to_cos=cfg.flip_sin_to_cos,
                              downscale_freq_shift=cfg.freq_shift)
    te = params["time_embedding"]
    temb = linear(te["linear_2"], silu(linear(te["linear_1"], temb.to(compute_dtype))))
    tids = timestep_embedding(added_time_ids.reshape(-1), cfg.addition_time_embed_dim,
                              flip_sin_to_cos=cfg.flip_sin_to_cos,
                              downscale_freq_shift=cfg.freq_shift).reshape(B, -1)
    add = torch.cat([added_text_embeds.to(compute_dtype), tids.to(compute_dtype)], -1)
    ae = params["add_embedding"]
    temb = temb + linear(ae["linear_2"], silu(linear(ae["linear_1"], add)))

    attn_maps = [] if capture_ip_attn_maps else None
    # the maps are appended as the forward runs, and a recomputed block
    # would append again: capture turns remat off (it is an eval mode)
    remat = cfg.remat and not capture_ip_attn_maps and torch.is_grad_enabled()

    def resnet(p, x):
        if remat:
            return checkpoint(_resnet, p, x, temb, gr, use_reentrant=False)
        return _resnet(p, x, temb, gr)

    def transformer(p, x):
        # a recomputed block issues its collectives again: every rank
        # recomputes the same blocks in the same order, its backward's
        if remat:
            return checkpoint(_transformer, p, x, context, cfg, gr, None, tp_axis, sp_axis,
                              use_reentrant=False)
        return _transformer(p, x, context, cfg, gr, attn_maps, tp_axis, sp_axis)

    x = conv2d(params["conv_in"], x)
    skips = [x]
    for block in params["down_blocks"]:
        attns = block["attentions"]
        for j, res in enumerate(block["resnets"]):
            x = resnet(res, x)
            if attns:
                x = transformer(attns[j], x)
            skips.append(x)
        if "downsample" in block:
            x = conv2d(block["downsample"], x, stride=2, padding=1)
            skips.append(x)
    mid = params["mid_block"]
    x = resnet(mid["resnets"][0], x)
    if mid["attentions"]:
        x = transformer(mid["attentions"][0], x)
    x = resnet(mid["resnets"][1], x)
    for block in params["up_blocks"]:
        attns = block["attentions"]
        for j, res in enumerate(block["resnets"]):
            x = resnet(res, torch.cat([x, skips.pop()], dim=1))
            if attns:
                x = transformer(attns[j], x)
        if "upsample" in block:
            x = conv2d(block["upsample"], F.interpolate(x, scale_factor=2,
                                                        mode="nearest"))
    x = silu(group_norm(params["conv_norm_out"], x, gr, eps=1e-5))
    eps = conv2d(params["conv_out"], x).float()
    if capture_ip_attn_maps:
        return eps, {"ip_attn_maps": attn_maps}
    return eps
