"""Plain float32 SDXL U-Net with the IP-Adapter's two-stream heads, the VAE,
the IP conditioning path and the DDIM scheduler.

A frozen copy of the port's ``models/diffusion/{nn,unet,vae,ip_adapter,
scheduler,sd_network}.py`` (stable_nerf_tpu_torch, as of the benchmark's
first version), with the tensor- and sequence-parallel paths, remat and the
attention-map capture taken out, every product in float32 (or the control's
precision, ``precision.py``), and ``*_template`` functions in place of the
random inits: they give each leaf's shape and fill, from which the
benchmark makes the weights (``benchmark/harness/weights.py``).

Param layout (diffusers key names): conv {"kernel" [O, I, kh, kw], "bias"},
linear {"kernel" [in, out], "bias"?}, norm {"scale", "bias"}; the VAE's
attention projections are stored [out, in].
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import precision


class Spec(NamedTuple):
    """A leaf of a template: its shape and how it is filled: "uniform" in
    (-scale, scale), "zeros" or "ones"."""
    shape: Tuple[int, ...]
    fill: str
    scale: float = 0.0


def _u(shape, scale):
    return Spec(tuple(shape), "uniform", float(scale))


def _zeros(n):
    return Spec((n,), "zeros")


def _ones(n):
    return Spec((n,), "ones")


# ---------------------------------------------------------------- primitives

def conv2d(p, x, stride=1, padding=1, full=False):
    q = precision.full if full else precision.low
    bias = p["bias"].float() if "bias" in p else None
    return F.conv2d(q(x), q(p["kernel"]), bias, stride=stride, padding=padding)


def linear(p, x):
    out = precision.low(x) @ precision.low(p["kernel"])
    if "bias" in p:
        out = out + p["bias"].float()
    return out


def group_norm(p, x, groups, eps=1e-6):
    return (F.group_norm(x, groups, eps=eps) * p["scale"].float()[None, :, None, None]
            + p["bias"].float()[None, :, None, None])


def layer_norm(p, x, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), eps=eps) * p["scale"].float() + p["bias"].float()


def silu(x):
    return x * torch.sigmoid(x)


def sdpa(q, k, v):
    attn = torch.softmax((q * q.shape[-1] ** -0.5) @ k.transpose(-1, -2), dim=-1)
    return attn @ v


def split_heads(x, n_heads):
    b, s, d = x.shape
    return x.reshape(b, s, n_heads, d // n_heads).transpose(1, 2)


def merge_heads(x):
    b, h, s, hd = x.shape
    return x.transpose(1, 2).reshape(b, s, h * hd)


def timestep_embedding(timesteps, dim, flip_sin_to_cos=True, downscale_freq_shift=0.0,
                       max_period=10000.0):
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                    device=timesteps.device)
    freqs = torch.exp(exponent / (half - downscale_freq_shift))
    args = timesteps.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


# --------------------------------------------------------------------- U-Net

def _lin_t(din, dout, bias=True):
    p = {"kernel": _u((din, dout), 1.0 / math.sqrt(din))}
    if bias:
        p["bias"] = _zeros(dout)
    return p


def _conv_t(cin, cout, k=3):
    return {"kernel": _u((cout, cin, k, k), 1.0 / math.sqrt(cin * k * k)),
            "bias": _zeros(cout)}


def _norm_t(c):
    return {"scale": _ones(c), "bias": _zeros(c)}


def _resnet_t(cin, cout, temb):
    p = {"norm1": _norm_t(cin), "conv1": _conv_t(cin, cout),
         "time_emb_proj": _lin_t(temb, cout), "norm2": _norm_t(cout),
         "conv2": _conv_t(cout, cout)}
    if cin != cout:
        p["conv_shortcut"] = _conv_t(cin, cout, 1)
    return p


def _attn_t(c, kv_dim, with_ip):
    p = {"to_q": _lin_t(c, c, False), "to_k": _lin_t(kv_dim, c, False),
         "to_v": _lin_t(kv_dim, c, False), "to_out": _lin_t(c, c)}
    if with_ip:
        p["to_k_ip"] = _lin_t(kv_dim, c, False)
        p["to_v_ip"] = _lin_t(kv_dim, c, False)
    return p


def _transformer_t(c, depth, u):
    block = lambda: {"norm1": _norm_t(c), "attn1": _attn_t(c, c, False),  # noqa: E731
                     "norm2": _norm_t(c),
                     "attn2": _attn_t(c, u["cross_attention_dim"], True),
                     "norm3": _norm_t(c), "ff_geglu": _lin_t(c, 8 * c),
                     "ff_out": _lin_t(4 * c, c)}
    return {"norm": _norm_t(c), "proj_in": _lin_t(c, c),
            "blocks": [block() for _ in range(depth)], "proj_out": _lin_t(c, c)}


def unet_template(u: Dict) -> Dict:
    ch, tl, lpb = u["block_out_channels"], u["transformer_layers"], u["layers_per_block"]
    ted = ch[0] * 4
    p = {"conv_in": _conv_t(u["in_channels"], ch[0]),
         "time_embedding": {"linear_1": _lin_t(ch[0], ted), "linear_2": _lin_t(ted, ted)},
         "add_embedding": {
             "linear_1": _lin_t(u["projection_class_embeddings_input_dim"], ted),
             "linear_2": _lin_t(ted, ted)}}
    down, cin = [], ch[0]
    for i, c in enumerate(ch):
        block = {"resnets": [], "attentions": []}
        for j in range(lpb):
            block["resnets"].append(_resnet_t(cin if j == 0 else c, c, ted))
            if tl[i] > 0:
                block["attentions"].append(_transformer_t(c, tl[i], u))
        if i < len(ch) - 1:
            block["downsample"] = _conv_t(c, c)
        down.append(block)
        cin = c
    p["down_blocks"] = down
    p["mid_block"] = {"resnets": [_resnet_t(ch[-1], ch[-1], ted) for _ in range(2)],
                      "attentions": ([_transformer_t(ch[-1], tl[-1], u)]
                                     if tl[-1] > 0 else [])}
    up, rev, rev_tl = [], tuple(reversed(ch)), tuple(reversed(tl))
    for i, c in enumerate(rev):
        prev_out = rev[i - 1] if i > 0 else rev[0]
        block = {"resnets": [], "attentions": []}
        for j in range(lpb + 1):
            skip_ch = rev[min(i + 1, len(rev) - 1)] if j == lpb else c
            block["resnets"].append(_resnet_t((prev_out if j == 0 else c) + skip_ch, c, ted))
            if rev_tl[i] > 0:
                block["attentions"].append(_transformer_t(c, rev_tl[i], u))
        if i < len(rev) - 1:
            block["upsample"] = _conv_t(c, c)
        up.append(block)
    p["up_blocks"] = up
    p["conv_norm_out"] = _norm_t(ch[0])
    p["conv_out"] = _conv_t(ch[0], u["out_channels"])
    return p


def _resnet(p, x, temb, groups):
    h = conv2d(p["conv1"], silu(group_norm(p["norm1"], x, groups, eps=1e-5)))
    h = h + linear(p["time_emb_proj"], silu(temb))[:, :, None, None]
    h = conv2d(p["conv2"], silu(group_norm(p["norm2"], h, groups, eps=1e-5)))
    if "conv_shortcut" in p:
        x = conv2d(p["conv_shortcut"], x, padding=0)
    return x + h


def _attention(p, x, context, head_dim, ip_tokens, ip_scale):
    n_heads = p["to_q"]["kernel"].shape[1] // head_dim
    q = split_heads(linear(p["to_q"], x), n_heads)

    def kv(k_p, v_p, ctx):
        return split_heads(linear(k_p, ctx), n_heads), split_heads(linear(v_p, ctx), n_heads)

    if context is None:
        out = merge_heads(sdpa(q, *kv(p["to_k"], p["to_v"], x)))
    elif "to_k_ip" in p and ip_tokens > 0:
        end = context.shape[1] - ip_tokens
        out = merge_heads(sdpa(q, *kv(p["to_k"], p["to_v"], context[:, :end])))
        out = out + ip_scale * merge_heads(sdpa(q, *kv(p["to_k_ip"], p["to_v_ip"],
                                                          context[:, end:])))
    else:
        out = merge_heads(sdpa(q, *kv(p["to_k"], p["to_v"], context)))
    return linear(p["to_out"], out)


def _transformer(p, x, context, u, groups):
    n, c, h, w = x.shape
    y = group_norm(p["norm"], x, groups, eps=1e-6).reshape(n, c, h * w).transpose(1, 2)
    y = linear(p["proj_in"], y)
    for blk in p["blocks"]:
        y = y + _attention(blk["attn1"], layer_norm(blk["norm1"], y), None,
                           u["head_dim"], 0, 0.0)
        y = y + _attention(blk["attn2"], layer_norm(blk["norm2"], y), context,
                           u["head_dim"], u["ip_num_tokens"], u["ip_scale"])
        val, gate = linear(blk["ff_geglu"], layer_norm(blk["norm3"], y)).chunk(2, dim=-1)
        y = y + linear(blk["ff_out"], val * F.gelu(gate))
    y = linear(p["proj_out"], y)
    return x + y.transpose(1, 2).reshape(n, c, h, w)


def unet_apply(params, sample, timesteps, context, *, added_text_embeds, added_time_ids,
               u: Dict):
    gr = u["norm_groups"]
    B = sample.shape[0]
    x = sample.float()
    context = context.float()
    ts = torch.as_tensor(timesteps, device=sample.device).expand(B)
    flip, shift = u["flip_sin_to_cos"], u["freq_shift"]
    temb = timestep_embedding(ts, u["block_out_channels"][0], flip, shift)
    te = params["time_embedding"]
    temb = linear(te["linear_2"], silu(linear(te["linear_1"], temb)))
    tids = timestep_embedding(added_time_ids.reshape(-1), u["addition_time_embed_dim"],
                              flip, shift).reshape(B, -1)
    ae = params["add_embedding"]
    add = torch.cat([added_text_embeds.float(), tids], -1)
    temb = temb + linear(ae["linear_2"], silu(linear(ae["linear_1"], add)))

    x = conv2d(params["conv_in"], x)
    skips = [x]
    for block in params["down_blocks"]:
        for j, res in enumerate(block["resnets"]):
            x = _resnet(res, x, temb, gr)
            if block["attentions"]:
                x = _transformer(block["attentions"][j], x, context, u, gr)
            skips.append(x)
        if "downsample" in block:
            x = conv2d(block["downsample"], x, stride=2, padding=1)
            skips.append(x)
    mid = params["mid_block"]
    x = _resnet(mid["resnets"][0], x, temb, gr)
    if mid["attentions"]:
        x = _transformer(mid["attentions"][0], x, context, u, gr)
    x = _resnet(mid["resnets"][1], x, temb, gr)
    for block in params["up_blocks"]:
        for j, res in enumerate(block["resnets"]):
            x = _resnet(res, torch.cat([x, skips.pop()], dim=1), temb, gr)
            if block["attentions"]:
                x = _transformer(block["attentions"][j], x, context, u, gr)
        if "upsample" in block:
            x = conv2d(block["upsample"], F.interpolate(x, scale_factor=2, mode="nearest"))
    x = silu(group_norm(params["conv_norm_out"], x, gr, eps=1e-5))
    return conv2d(params["conv_out"], x)


# ----------------------------------------------------------------------- VAE

def _vconv_t(ci, co, k):
    return {"kernel": _u((co, ci, k, k), 1.0 / math.sqrt(ci * k * k)), "bias": _zeros(co)}


def _vres_t(cin, cout):
    p = {"norm1": _norm_t(cin), "conv1": _vconv_t(cin, cout, 3),
         "norm2": _norm_t(cout), "conv2": _vconv_t(cout, cout, 3)}
    if cin != cout:
        p["conv_shortcut"] = _vconv_t(cin, cout, 1)
    return p


def _vattn_t(c):
    lin = lambda: {"kernel": _u((c, c), 1.0 / math.sqrt(c)), "bias": _zeros(c)}  # noqa: E731
    return {"group_norm": _norm_t(c), "to_q": lin(), "to_k": lin(), "to_v": lin(),
            "to_out": lin()}


def _vmid_t(c):
    r0, a, r1 = _vres_t(c, c), _vattn_t(c), _vres_t(c, c)
    return {"resnets": [r0, r1], "attentions": [a]}


def vae_template(v: Dict) -> Dict:
    ch, lpb = v["block_out_channels"], v["layers_per_block"]
    enc, cin = [], ch[0]
    for i, c in enumerate(ch):
        block = {"resnets": [_vres_t(cin if j == 0 else c, c) for j in range(lpb)]}
        if i < len(ch) - 1:
            block["downsample"] = _vconv_t(c, c, 3)
        enc.append(block)
        cin = c
    dch = tuple(reversed(ch))
    dec, cin = [], dch[0]
    for i, c in enumerate(dch):
        block = {"resnets": [_vres_t(cin if j == 0 else c, c) for j in range(lpb + 1)]}
        if i < len(dch) - 1:
            block["upsample"] = _vconv_t(c, c, 3)
        dec.append(block)
        cin = c
    lc = v["latent_channels"]
    return {"encoder": {"conv_in": _vconv_t(v["in_channels"], ch[0], 3), "down_blocks": enc,
                        "mid": _vmid_t(ch[-1]), "norm_out": _norm_t(ch[-1]),
                        "conv_out": _vconv_t(ch[-1], 2 * lc, 3)},
            "quant_conv": _vconv_t(2 * lc, 2 * lc, 1),
            "post_quant_conv": _vconv_t(lc, lc, 1),
            "decoder": {"conv_in": _vconv_t(lc, dch[0], 3), "mid": _vmid_t(dch[0]),
                        "up_blocks": dec, "norm_out": _norm_t(dch[-1]),
                        "conv_out": _vconv_t(dch[-1], v["in_channels"], 3)}}


def _vconv(p, x, **kw):
    return conv2d(p, x, full=True, **kw)


def _vres(p, x, gr):
    h = _vconv(p["conv1"], silu(group_norm(p["norm1"], x, gr)))
    h = _vconv(p["conv2"], silu(group_norm(p["norm2"], h, gr)))
    if "conv_shortcut" in p:
        x = _vconv(p["conv_shortcut"], x, padding=0)
    return x + h


def _vattn(p, x, gr):
    n, c, h, w = x.shape
    y = group_norm(p["group_norm"], x, gr).reshape(n, c, h * w).transpose(1, 2)

    def proj(q):
        return precision.full(y) @ precision.full(q["kernel"]).T + q["bias"].float()

    o = sdpa(proj(p["to_q"])[:, None], proj(p["to_k"])[:, None],
             proj(p["to_v"])[:, None])[:, 0]
    o = precision.full(o) @ precision.full(p["to_out"]["kernel"]).T + p["to_out"]["bias"].float()
    return x + o.transpose(1, 2).reshape(n, c, h, w)


def _vmid(p, x, gr):
    x = _vres(p["resnets"][0], x, gr)
    x = _vattn(p["attentions"][0], x, gr)
    return _vres(p["resnets"][1], x, gr)


def vae_moments(params, x, v):
    gr = v["norm_groups"]
    e = params["encoder"]
    h = _vconv(e["conv_in"], x.float())
    for block in e["down_blocks"]:
        for r in block["resnets"]:
            h = _vres(r, h, gr)
        if "downsample" in block:
            h = _vconv(block["downsample"], F.pad(h, (0, 1, 0, 1)), stride=2, padding=0)
    h = _vmid(e["mid"], h, gr)
    h = _vconv(e["conv_out"], silu(group_norm(e["norm_out"], h, gr)))
    mean, logvar = _vconv(params["quant_conv"], h, padding=0).chunk(2, dim=1)
    return mean, torch.clamp(logvar, -30.0, 20.0)


def vae_encode_sample(params, x, v, eps):
    mean, logvar = vae_moments(params, x, v)
    return (mean + torch.exp(0.5 * logvar) * eps) * v["scaling_factor"]


def vae_encode_mode(params, x, v):
    return vae_moments(params, x, v)[0] * v["scaling_factor"]


def vae_decode(params, z, v):
    gr = v["norm_groups"]
    d = params["decoder"]
    h = _vconv(params["post_quant_conv"], z.float() / v["scaling_factor"], padding=0)
    h = _vconv(d["conv_in"], h)
    h = _vmid(d["mid"], h, gr)
    for block in d["up_blocks"]:
        for r in block["resnets"]:
            h = _vres(r, h, gr)
        if "upsample" in block:
            h = _vconv(block["upsample"], F.interpolate(h, scale_factor=2, mode="nearest"))
    return _vconv(d["conv_out"], silu(group_norm(d["norm_out"], h, gr)))


# ------------------------------------------------------------ the IP path

def proj_dim(sd: Dict) -> int:
    if sd["use_downsampling_layers"]:
        return 64 * max(sd["latent_size"] // 16, 1) ** 2
    return sd["cond_channels"] * sd["latent_size"] ** 2


def sd_template(cfg: Dict) -> Dict:
    """The SD network's tree: VAE, U-Net with IP heads, image projection,
    the downsampling CNN, the cached empty-prompt conditioning."""
    sd, u = cfg["sd"], cfg["unet"]
    d, ca, nt = proj_dim(sd), u["cross_attention_dim"], sd["num_tokens"]
    t = {"vae": vae_template(cfg["vae"]), "unet": unet_template(u),
         "image_proj": {"proj": {"kernel": _u((d, nt * ca), 1.0 / math.sqrt(d)),
                                 "bias": _zeros(nt * ca)},
                        "norm": _norm_t(ca)}}
    if sd["use_downsampling_layers"]:
        c = sd["cond_channels"]
        t["downsampling"] = {"conv1": _vconv_t(c, 16, 4), "conv2": _vconv_t(16, 32, 4),
                             "conv3": _vconv_t(32, 64, 4)}
    return t


def embed_conditions(params, image_embeds, cfg, views=2):
    x = image_embeds.float()
    if "downsampling" in params:
        ds = params["downsampling"]
        x = torch.relu(conv2d(ds["conv1"], x, stride=2, padding=1, full=True))
        x = torch.relu(conv2d(ds["conv2"], x, stride=2, padding=1, full=True))
        x = torch.relu(conv2d(ds["conv3"], x, stride=4, padding=0, full=True))
    ip = params["image_proj"]
    dd = ip["norm"]["scale"].shape[0]
    # the conditioning path runs in float32 in the program: TF32 is its step down
    tokens = (precision.full(x.reshape(x.shape[0], -1)) @ precision.full(ip["proj"]["kernel"])
              + ip["proj"]["bias"])
    tokens = tokens.reshape(tokens.shape[0], -1, dd)
    tokens = F.layer_norm(tokens, (dd,), eps=1e-5) * ip["norm"]["scale"] + ip["norm"]["bias"]
    return tokens.reshape(x.shape[0] // views, views * cfg["sd"]["num_tokens"], -1)


def sd_forward(params, noisy_latents, timesteps, image_embeds, cfg, add_text_embeds,
               add_time_ids):
    ip_tokens = embed_conditions(params, image_embeds, cfg)
    B = noisy_latents.shape[0]
    return unet_apply(params["unet"], noisy_latents, timesteps, ip_tokens,
                      added_text_embeds=add_text_embeds.expand(B, add_text_embeds.shape[-1]),
                      added_time_ids=add_time_ids.expand(B, 6), u=cfg["unet"])


# --------------------------------------------------------------------- DDIM

class DDIM:
    """DDIM, eta 0, as diffusers' DDIMScheduler with SDXL's settings."""

    def __init__(self, s: Dict, device):
        T = s["num_train_timesteps"]
        if s["beta_schedule"] != "scaled_linear":
            raise ValueError(f"unsupported beta_schedule {s['beta_schedule']}")
        betas = np.linspace(s["beta_start"] ** 0.5, s["beta_end"] ** 0.5, T) ** 2
        acp = np.cumprod(1.0 - betas)
        self.s = s
        self.acp = torch.tensor(acp.astype(np.float32), device=device)
        self.final = float(np.float32(1.0 if s["set_alpha_to_one"] else acp[0]))

    def add_noise(self, x0, noise, t):
        a = self.acp[t].reshape(-1, *([1] * (x0.dim() - 1)))
        return torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * noise

    def timesteps(self, n: int):
        s = self.s
        if s["timestep_spacing"] != "leading":
            raise ValueError(f"unsupported timestep_spacing {s['timestep_spacing']}")
        ratio = s["num_train_timesteps"] // n
        return [int(v) + s["steps_offset"] for v in (np.arange(n) * ratio).round()[::-1]]

    def step(self, eps, t: int, x, n: int):
        prev = t - self.s["num_train_timesteps"] // n
        a_t = self.acp[t]
        a_prev = self.acp[prev] if prev >= 0 else torch.tensor(self.final, device=x.device)
        x0 = (x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
        return torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps


def psnr(a, b):
    mse = ((a - b) ** 2).reshape(a.shape[0], -1).mean(dim=1)
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse))

