"""Analytic FLOP counts of the SDXL U-Net forward pass (counterpart of
stable_nerf_tpu/utils/flops.py).

The count walks the ``UNetConfig`` the way ``unet_apply`` does and counts
a multiply-add of a convolution or a matrix product as 2 FLOPs, the
convention in which the card's peak rates are quoted.  It is the
numerator of the MFU that scripts/profile_torch_sd_denoise.py
(``mfu_analytic``) and scripts/bench_torch_joint_full_sdxl.py report.

Counted: every conv2d (K·K·Cin·Cout·H·W·2), every linear, the attention
score and value products (2·S·S_kv·D·heads·2 a layer) and the time and
added-condition embedding MLPs.  Not counted: norms, SiLU/GEGLU pointwise
work and softmax, under 1% of the total at SDXL's shapes (they cost
bytes, not FLOPs).
"""

from __future__ import annotations

from ..models.diffusion.unet import UNetConfig


def _conv(cin, cout, h, w, k=3):
    return 2 * k * k * cin * cout * h * w


def _linear(din, dout, tokens=1):
    return 2 * din * dout * tokens


def _resnet(cin, cout, h, w, temb_dim):
    f = _conv(cin, cout, h, w) + _conv(cout, cout, h, w)
    f += _linear(temb_dim, cout)                    # time projection
    if cin != cout:
        f += _conv(cin, cout, h, w, k=1)            # shortcut
    return f


def _attention(s_q, s_kv, dim, inner, ip_tokens=0):
    """One attention: q/k/v/out projections and the score/value products.

    ``dim`` is the width of the k/v source (``inner`` for self-attention,
    cross_attention_dim for cross-attention), ``inner`` the q and output
    width.  ``ip_tokens`` > 0 adds the ip stream's k/v projections and its
    score/value products (the two-stream split of the IP-Adapter)."""
    f = _linear(inner, inner, s_q)                  # to_q
    f += 2 * _linear(dim, inner, s_kv)              # to_k, to_v
    f += _linear(inner, inner, s_q)                 # to_out
    f += 2 * 2 * s_q * s_kv * inner                 # QK^T and attn@V
    if ip_tokens:
        f += 2 * _linear(dim, inner, ip_tokens)     # to_k_ip, to_v_ip
        f += 2 * 2 * s_q * ip_tokens * inner
    return f


def _transformer_block(s, c, cfg: UNetConfig, tokens: int):
    """One BasicTransformerBlock: self-attention, (ip) cross-attention,
    GEGLU feed-forward."""
    f = _attention(s, s, c, c)                                   # attn1
    # the text stream sees tokens − ip_num_tokens, the ip stream the rest
    text_tokens = max(tokens - cfg.ip_num_tokens, 0)
    f += _attention(s, text_tokens, cfg.cross_attention_dim, c,
                    ip_tokens=cfg.ip_num_tokens)                 # attn2
    f += _linear(c, 8 * c, s) + _linear(4 * c, c, s)             # GEGLU ff
    return f


def _transformer(s, c, depth, cfg: UNetConfig, tokens: int):
    f = _linear(c, c, s) * 2                        # proj_in / proj_out
    f += depth * _transformer_block(s, c, cfg, tokens)
    return f


def unet_forward_flops(cfg: UNetConfig, batch: int, latent: int,
                       cond_tokens: int = 4) -> int:
    """FLOPs of one ``unet_apply`` at [batch, 4, latent, latent].

    ``cond_tokens``: the conditioning sequence's length (the reference
    conditions on 4 ip tokens: 2 views × 2 tokens)."""
    ch = cfg.block_out_channels
    temb = cfg.time_embed_dim
    f = 0

    # time and added-condition embedding MLPs (one token a batch element)
    f += _linear(ch[0], temb) + _linear(temb, temb)
    f += _linear(cfg.projection_class_embeddings_input_dim, temb)
    f += _linear(temb, temb)

    h = latent
    f += _conv(cfg.in_channels, ch[0], h, h)        # conv_in

    # down path
    skips_ch = [ch[0]]
    c_in = ch[0]
    for i, c in enumerate(ch):
        for _ in range(cfg.layers_per_block):
            f += _resnet(c_in, c, h, h, temb)
            if cfg.transformer_layers[i] > 0:
                f += _transformer(h * h, c, cfg.transformer_layers[i],
                                  cfg, cond_tokens)
            c_in = c
            skips_ch.append(c)
        if i < len(ch) - 1:
            f += _conv(c, c, h // 2, h // 2)        # stride-2 downsample
            h //= 2
            skips_ch.append(c)

    # mid block
    f += _resnet(ch[-1], ch[-1], h, h, temb)
    if cfg.transformer_layers[-1] > 0:
        f += _transformer(h * h, ch[-1], cfg.transformer_layers[-1],
                          cfg, cond_tokens)
    f += _resnet(ch[-1], ch[-1], h, h, temb)

    # up path: layers_per_block + 1 resnets a level, the skip concatenated
    # onto the input channels
    rev = tuple(reversed(ch))
    rev_tl = tuple(reversed(cfg.transformer_layers))
    c_in = ch[-1]
    for i, c in enumerate(rev):
        for _ in range(cfg.layers_per_block + 1):
            skip = skips_ch.pop()
            f += _resnet(c_in + skip, c, h, h, temb)
            if rev_tl[i] > 0:
                f += _transformer(h * h, c, rev_tl[i], cfg, cond_tokens)
            c_in = c
        if i < len(rev) - 1:
            h *= 2
            f += _conv(c, c, h, h)                  # upsample conv
    if skips_ch:
        raise AssertionError("skip connections left over: the walk does not "
                             "mirror unet_apply")

    f += _conv(ch[0], cfg.out_channels, latent, latent)  # conv_out
    return batch * f
