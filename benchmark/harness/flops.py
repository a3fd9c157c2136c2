"""Operations and bytes of the work a cell asks for, from shapes alone, and
the card's data-sheet peaks.

``unet_forward_flops`` is a frozen copy of the port's ``utils/flops.py``
(stable_nerf_tpu_torch, as of the benchmark's first version), reading a
configuration file's ``unet`` section.  Added here: the VAE encoder and
decoder, the NeRF MLPs, the counts a train step, a request and a fit step
need, and K1's bytes.  A multiply-add is 2 FLOPs; norms, pointwise work and
softmax are not counted.  ``PEAK_BF16_FLOPS`` is a frozen copy of
``scripts/torch_study.py::PEAK_BF16_FLOPS``.
"""

from __future__ import annotations

from typing import Dict

# dense (no sparsity) bf16 tensor-core peaks and HBM bandwidth by
# torch.cuda.get_device_name, from NVIDIA's H100 data sheet (700 W SXM)
PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989.4e12,
    "NVIDIA H100 PCIe": 756.5e12,
    "NVIDIA H100 NVL": 835.5e12,
}
PEAK_HBM_BYTES = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
    "NVIDIA H100 NVL": 3.9e12,
}


def _conv(cin, cout, h, w, k=3):
    return 2 * k * k * cin * cout * h * w


def _linear(din, dout, tokens=1):
    return 2 * din * dout * tokens


def _resnet(cin, cout, h, w, temb_dim):
    f = _conv(cin, cout, h, w) + _conv(cout, cout, h, w) + _linear(temb_dim, cout)
    if cin != cout:
        f += _conv(cin, cout, h, w, k=1)
    return f


def _attention(s_q, s_kv, dim, inner, ip_tokens=0):
    f = _linear(inner, inner, s_q) + 2 * _linear(dim, inner, s_kv) + _linear(inner, inner, s_q)
    f += 2 * 2 * s_q * s_kv * inner
    if ip_tokens:
        f += 2 * _linear(dim, inner, ip_tokens) + 2 * 2 * s_q * ip_tokens * inner
    return f


def _transformer_block(s, c, u, tokens):
    f = _attention(s, s, c, c)
    f += _attention(s, max(tokens - u["ip_num_tokens"], 0), u["cross_attention_dim"], c,
                    ip_tokens=u["ip_num_tokens"])
    return f + _linear(c, 8 * c, s) + _linear(4 * c, c, s)


def _transformer(s, c, depth, u, tokens):
    return _linear(c, c, s) * 2 + depth * _transformer_block(s, c, u, tokens)


def unet_forward_flops(u: Dict, batch: int, latent: int, cond_tokens: int = 4) -> int:
    """FLOPs of one U-Net forward at [batch, 4, latent, latent]."""
    ch, tl, lpb = u["block_out_channels"], u["transformer_layers"], u["layers_per_block"]
    temb = ch[0] * 4
    f = _linear(ch[0], temb) + _linear(temb, temb)
    f += _linear(u["projection_class_embeddings_input_dim"], temb) + _linear(temb, temb)
    h = latent
    f += _conv(u["in_channels"], ch[0], h, h)
    skips, c_in = [ch[0]], ch[0]
    for i, c in enumerate(ch):
        for _ in range(lpb):
            f += _resnet(c_in, c, h, h, temb)
            if tl[i] > 0:
                f += _transformer(h * h, c, tl[i], u, cond_tokens)
            c_in = c
            skips.append(c)
        if i < len(ch) - 1:
            f += _conv(c, c, h // 2, h // 2)
            h //= 2
            skips.append(c)
    f += 2 * _resnet(ch[-1], ch[-1], h, h, temb)
    if tl[-1] > 0:
        f += _transformer(h * h, ch[-1], tl[-1], u, cond_tokens)
    c_in = ch[-1]
    for i, c in enumerate(reversed(ch)):
        for _ in range(lpb + 1):
            f += _resnet(c_in + skips.pop(), c, h, h, temb)
            if tuple(reversed(tl))[i] > 0:
                f += _transformer(h * h, c, tuple(reversed(tl))[i], u, cond_tokens)
            c_in = c
        if i < len(ch) - 1:
            h *= 2
            f += _conv(c, c, h, h)
    f += _conv(ch[0], u["out_channels"], latent, latent)
    return batch * f


def ip_weight_grad_flops(u: Dict, batch: int, cond_tokens: int = 4) -> int:
    """The IP heads' weight gradients: each to_k_ip / to_v_ip is a
    [cross_attention_dim, c] product over the ip tokens."""
    ch, tl, lpb = u["block_out_channels"], u["transformer_layers"], u["layers_per_block"]
    blocks = sum(ch[i] * tl[i] * lpb for i in range(len(ch)))               # down
    blocks += ch[-1] * tl[-1]                                                # mid
    blocks += sum(ch[i] * tl[i] * (lpb + 1) for i in range(len(ch)))        # up
    return batch * 2 * _linear(u["cross_attention_dim"], 1, u["ip_num_tokens"]) * blocks


def _vae_resnet(cin, cout, h):
    f = _conv(cin, cout, h, h) + _conv(cout, cout, h, h)
    return f + (_conv(cin, cout, h, h, k=1) if cin != cout else 0)


def _vae_mid(c, h):
    s = h * h
    return 2 * _vae_resnet(c, c, h) + 4 * _linear(c, c, s) + 2 * 2 * s * s * c


def vae_encode_flops(v: Dict, batch: int, image: int) -> int:
    ch, lpb, lc = v["block_out_channels"], v["layers_per_block"], v["latent_channels"]
    h, f, cin = image, _conv(v["in_channels"], ch[0], image, image), ch[0]
    for i, c in enumerate(ch):
        for j in range(lpb):
            f += _vae_resnet(cin if j == 0 else c, c, h)
        cin = c
        if i < len(ch) - 1:
            h //= 2
            f += _conv(c, c, h, h)
    f += _vae_mid(ch[-1], h) + _conv(ch[-1], 2 * lc, h, h) + _conv(2 * lc, 2 * lc, h, h, k=1)
    return batch * f


def vae_decode_flops(v: Dict, batch: int, latent: int) -> int:
    ch, lpb, lc = tuple(reversed(v["block_out_channels"])), v["layers_per_block"], v["latent_channels"]
    h = latent
    f = _conv(lc, lc, h, h, k=1) + _conv(lc, ch[0], h, h) + _vae_mid(ch[0], h)
    cin = ch[0]
    for i, c in enumerate(ch):
        for j in range(lpb + 1):
            f += _vae_resnet(cin if j == 0 else c, c, h)
        cin = c
        if i < len(ch) - 1:
            h *= 2
            f += _conv(c, c, h, h)
    return batch * (f + _conv(ch[-1], v["in_channels"], h, h))


def _mlp(di, do, width, hidden):
    dims = [di] + [width] * hidden + [do]
    return sum(_linear(a, b) for a, b in zip(dims[:-1], dims[1:]))


def nerf_sample_flops(n: Dict, density_only: bool = False) -> int:
    """The MLPs' forward FLOPs for one sample."""
    h = n["encoding_sigma"]
    f = _mlp(h["n_levels"] * h["n_features_per_level"], 1 + n["geo_feat_dim"],
             n["network_sigma"]["n_neurons"], n["network_sigma"]["n_hidden_layers"])
    if not density_only:
        f += _mlp(n["encoding_dir"]["degree"] ** 2 + n["geo_feat_dim"], n["channel_dim"],
                  n["network_color"]["n_neurons"], n["network_color"]["n_hidden_layers"])
    return f


def joint_step_flops(cfg: Dict) -> int:
    """A dense joint train step: the VAE encode of 2B images, the NeRF's
    forward and backward (3x its forward) on every lattice sample, the
    U-Net's forward and its activation gradients (2x its forward) and the
    IP heads' weight gradients.  Recomputed work is not counted."""
    t, s, u = cfg["train"], cfg["sd"], cfg["unet"]
    B, lat = t["batch_size"], s["latent_size"]
    samples = 2 * B * lat * lat * t["max_steps_train"]
    if t["sample_budget"] is not None:
        samples = min(samples, t["sample_budget"])
    tokens = 2 * s["num_tokens"]
    return (vae_encode_flops(cfg["vae"], 2 * B, s["image_size"])
            + 3 * samples * nerf_sample_flops(cfg["nerf"])
            + 2 * unet_forward_flops(u, B, lat, tokens) + ip_weight_grad_flops(u, B, tokens))


def request_flops(cfg: Dict, batch: int, num_steps: int, budget: int) -> int:
    """A request: the reference views' encode, the eval render's budget of
    samples, ``num_steps`` U-Net forwards, the decode and the target's
    mode encode."""
    s = cfg["sd"]
    return (2 * vae_encode_flops(cfg["vae"], batch, s["image_size"])
            + budget * nerf_sample_flops(cfg["nerf"])
            + num_steps * unet_forward_flops(cfg["unet"], batch, s["latent_size"],
                                             2 * s["num_tokens"])
            + vae_decode_flops(cfg["vae"], batch, s["latent_size"]))


def fit_step_flops(cfg: Dict, rays: int, max_steps: int, refresh_every: int) -> float:
    """A dense fit step (3x the MLPs' forward on every lattice sample) and
    its share of the refresh's density sweep (grid_size³ samples a
    cascade every ``refresh_every`` steps)."""
    n = cfg["nerf"]
    sweep = n["grid_size"] ** 3 * nerf_sample_flops(n, density_only=True)
    return 3 * rays * max_steps * nerf_sample_flops(n) + sweep / refresh_every


def scatter_bytes(m: int, levels: int, corners: int, feat: int, table: int) -> int:
    """K1's bytes for one launch: the int32 rows and the float32 updates
    read once, the float32 table written once."""
    return m * levels * corners * 4 + m * levels * corners * feat * 4 + levels * table * feat * 4
