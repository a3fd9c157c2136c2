"""Pretrained-weight loading: HF diffusers/transformers checkpoints → the
port's param trees (counterpart of stable_nerf_tpu/models/diffusion/
weights.py).

The reference pulls ``stabilityai/stable-diffusion-xl-base-1.0`` with
``from_pretrained`` (reference stable_diffusion/network.py:21-47).  This
module converts that directory's state dicts (``.safetensors`` through the
port's own reader, ``.bin`` through ``torch.load(weights_only=True)``)
into the trees of vae.py, unet.py and clip_text.py.  The port keeps the
JAX package's array layouts, so linears are transposed to [in, out] as
there; every leaf becomes float32 on load (the frozen bf16 cast comes
later, in ``training.loop.build_initial_params``).

A float32 ``.safetensors`` file is mapped, and its converted leaves are
views of the map: loading onto the CPU copies nothing.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, Optional, Tuple

import torch

from ...utils.device import resolve_device
from ...utils.safetensors import load_file, read_shapes
from .nn import META_GENERATOR
from .unet import UNetConfig, unet_init
from .vae import VAEConfig, vae_init

DIFFUSION_NAMES = ("diffusion_pytorch_model.safetensors", "diffusion_pytorch_model.bin")
TEXT_NAMES = ("model.safetensors", "pytorch_model.bin")


def _to_f32(x, device=None) -> torch.Tensor:
    """A checkpoint leaf (tensor or numpy array) as float32 on ``device``
    (None: where it is).  A float32 leaf already there is returned as is."""
    return torch.as_tensor(x).detach().to(device=device, dtype=torch.float32)


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch-format state dict from a ``.safetensors`` or ``.bin`` file,
    on the CPU."""
    if path.endswith(".safetensors"):
        return load_file(path)
    return torch.load(path, map_location="cpu", weights_only=True)


class _SD:
    """Key access with conversion bookkeeping."""

    def __init__(self, sd: Dict, device=None):
        self.sd, self.device = sd, device
        self.used = set()

    def t(self, key):
        self.used.add(key)
        try:
            return _to_f32(self.sd[key], self.device)
        except KeyError:
            near = sorted(k for k in self.sd
                          if k.rsplit(".", 2)[0] == key.rsplit(".", 2)[0])
            raise KeyError(
                f"checkpoint is missing key {key!r}"
                + (f"; keys with the same parent: {near[:6]}" if near else "")) from None

    def lin(self, prefix, transpose=True):
        p = {"kernel": self.t(prefix + ".weight")}
        if transpose:
            p["kernel"] = p["kernel"].T
        if prefix + ".bias" in self.sd:
            p["bias"] = self.t(prefix + ".bias")
        return p

    def conv(self, prefix):
        return {"kernel": self.t(prefix + ".weight"), "bias": self.t(prefix + ".bias")}

    def norm(self, prefix):
        return {"scale": self.t(prefix + ".weight"), "bias": self.t(prefix + ".bias")}

    def has(self, key):
        return key in self.sd

    def check_all_used(self, what: str, ignore: Tuple[str, ...] = ()):
        """Raise if the checkpoint held keys the converter never consumed: a
        renamed diffusers key must fail at load time, not leave random init
        in the tree."""
        unused = {k for k in self.sd if k not in self.used
                  and not any(k == ig or k.startswith(ig + ".") or k.endswith("." + ig)
                              for ig in ignore)}
        if unused:
            raise ValueError(
                f"{what}: {len(unused)} checkpoint key(s) were not consumed by the "
                f"converter — config/naming mismatch? e.g. {sorted(unused)[:10]}")


# ---------------------------------------------------------------------------
# VAE
# ---------------------------------------------------------------------------

def vae_params_from_state_dict(sd: Dict, cfg: VAEConfig = VAEConfig(),
                               strict: bool = False, *, device=None) -> Dict:
    """diffusers AutoencoderKL state dict → vae.py param tree, float32 on
    ``device`` (None: where the state dict's tensors are).  ``strict``
    also asserts that every checkpoint key was consumed."""
    s = _SD(sd, device)

    def resnet(prefix):
        p = {"norm1": s.norm(prefix + ".norm1"), "conv1": s.conv(prefix + ".conv1"),
             "norm2": s.norm(prefix + ".norm2"), "conv2": s.conv(prefix + ".conv2")}
        if s.has(prefix + ".conv_shortcut.weight"):
            p["conv_shortcut"] = s.conv(prefix + ".conv_shortcut")
        return p

    def attn(prefix):
        # diffusers' attention linears are [out, in]; vae.py applies
        # kernel.T, so they are stored untransposed
        return {"group_norm": s.norm(prefix + ".group_norm"),
                **{n: {"kernel": s.t(f"{prefix}.{n}.weight"),
                       "bias": s.t(f"{prefix}.{n}.bias")} for n in ("to_q", "to_k", "to_v")},
                "to_out": {"kernel": s.t(prefix + ".to_out.0.weight"),
                           "bias": s.t(prefix + ".to_out.0.bias")}}

    def mid(prefix):
        return {"resnets": [resnet(prefix + ".resnets.0"), resnet(prefix + ".resnets.1")],
                "attentions": [attn(prefix + ".attentions.0")]}

    n = len(cfg.block_out_channels)
    enc_blocks = []
    for i in range(n):
        block = {"resnets": [resnet(f"encoder.down_blocks.{i}.resnets.{j}")
                             for j in range(cfg.layers_per_block)]}
        if i < n - 1:
            block["downsample"] = s.conv(f"encoder.down_blocks.{i}.downsamplers.0.conv")
        enc_blocks.append(block)
    dec_blocks = []
    for i in range(n):
        block = {"resnets": [resnet(f"decoder.up_blocks.{i}.resnets.{j}")
                             for j in range(cfg.layers_per_block + 1)]}
        if i < n - 1:
            block["upsample"] = s.conv(f"decoder.up_blocks.{i}.upsamplers.0.conv")
        dec_blocks.append(block)

    out = {
        "encoder": {"conv_in": s.conv("encoder.conv_in"), "down_blocks": enc_blocks,
                    "mid": mid("encoder.mid_block"),
                    "norm_out": s.norm("encoder.conv_norm_out"),
                    "conv_out": s.conv("encoder.conv_out")},
        "quant_conv": s.conv("quant_conv"),
        "post_quant_conv": s.conv("post_quant_conv"),
        "decoder": {"conv_in": s.conv("decoder.conv_in"), "mid": mid("decoder.mid_block"),
                    "up_blocks": dec_blocks, "norm_out": s.norm("decoder.conv_norm_out"),
                    "conv_out": s.conv("decoder.conv_out")},
    }
    if strict:
        s.check_all_used("VAE")
    return out


# ---------------------------------------------------------------------------
# U-Net
# ---------------------------------------------------------------------------

def unet_params_from_state_dict(sd: Dict, cfg: UNetConfig = UNetConfig(),
                                with_ip: bool = True, strict: bool = False, *,
                                device=None) -> Dict:
    """diffusers UNet2DConditionModel state dict → unet.py param tree,
    float32 on ``device`` (None: where the state dict's tensors are).

    With ``with_ip`` and no ip weights in the state dict, to_k_ip/to_v_ip
    start as clones of to_k/to_v (the reference's init, stable_diffusion/
    network.py:104-110).  ``strict`` also asserts that every checkpoint key
    was consumed."""
    s = _SD(sd, device)

    def resnet(prefix):
        p = {"norm1": s.norm(prefix + ".norm1"), "conv1": s.conv(prefix + ".conv1"),
             "time_emb_proj": s.lin(prefix + ".time_emb_proj"),
             "norm2": s.norm(prefix + ".norm2"), "conv2": s.conv(prefix + ".conv2")}
        if s.has(prefix + ".conv_shortcut.weight"):
            p["conv_shortcut"] = s.conv(prefix + ".conv_shortcut")
        return p

    def attention(prefix, cross):
        p = {"to_q": s.lin(prefix + ".to_q"), "to_k": s.lin(prefix + ".to_k"),
             "to_v": s.lin(prefix + ".to_v"), "to_out": s.lin(prefix + ".to_out.0")}
        if cross and with_ip:
            if s.has(prefix + ".to_k_ip.weight"):
                p["to_k_ip"] = s.lin(prefix + ".to_k_ip")
                p["to_v_ip"] = s.lin(prefix + ".to_v_ip")
            else:
                p["to_k_ip"] = {"kernel": p["to_k"]["kernel"].clone()}
                p["to_v_ip"] = {"kernel": p["to_v"]["kernel"].clone()}
        return p

    def tblock(prefix):
        return {"norm1": s.norm(prefix + ".norm1"),
                "attn1": attention(prefix + ".attn1", cross=False),
                "norm2": s.norm(prefix + ".norm2"),
                "attn2": attention(prefix + ".attn2", cross=True),
                "norm3": s.norm(prefix + ".norm3"),
                "ff_geglu": s.lin(prefix + ".ff.net.0.proj"),
                "ff_out": s.lin(prefix + ".ff.net.2")}

    def transformer(prefix, depth):
        return {"norm": s.norm(prefix + ".norm"), "proj_in": s.lin(prefix + ".proj_in"),
                "blocks": [tblock(f"{prefix}.transformer_blocks.{d}") for d in range(depth)],
                "proj_out": s.lin(prefix + ".proj_out")}

    n = len(cfg.block_out_channels)
    down = []
    for i in range(n):
        block = {"resnets": [], "attentions": []}
        for j in range(cfg.layers_per_block):
            block["resnets"].append(resnet(f"down_blocks.{i}.resnets.{j}"))
            if cfg.transformer_layers[i] > 0:
                block["attentions"].append(transformer(f"down_blocks.{i}.attentions.{j}",
                                                       cfg.transformer_layers[i]))
        if i < n - 1:
            block["downsample"] = s.conv(f"down_blocks.{i}.downsamplers.0.conv")
        down.append(block)

    rev_tl = tuple(reversed(cfg.transformer_layers))
    up = []
    for i in range(n):
        block = {"resnets": [], "attentions": []}
        for j in range(cfg.layers_per_block + 1):
            block["resnets"].append(resnet(f"up_blocks.{i}.resnets.{j}"))
            if rev_tl[i] > 0:
                block["attentions"].append(transformer(f"up_blocks.{i}.attentions.{j}",
                                                       rev_tl[i]))
        if i < n - 1:
            block["upsample"] = s.conv(f"up_blocks.{i}.upsamplers.0.conv")
        up.append(block)

    out = {
        "conv_in": s.conv("conv_in"),
        "time_embedding": {"linear_1": s.lin("time_embedding.linear_1"),
                           "linear_2": s.lin("time_embedding.linear_2")},
        "add_embedding": {"linear_1": s.lin("add_embedding.linear_1"),
                          "linear_2": s.lin("add_embedding.linear_2")},
        "down_blocks": down,
        "mid_block": {
            "resnets": [resnet("mid_block.resnets.0"), resnet("mid_block.resnets.1")],
            "attentions": [transformer("mid_block.attentions.0", cfg.transformer_layers[-1])]
            if cfg.transformer_layers[-1] > 0 else [],
        },
        "up_blocks": up,
        "conv_norm_out": s.norm("conv_norm_out"),
        "conv_out": s.conv("conv_out"),
    }
    if strict:
        s.check_all_used("U-Net")
    return out


# ---------------------------------------------------------------------------
# export (the port's tree → diffusers naming) and key-manifest templates
# ---------------------------------------------------------------------------

def export_unet_state_dict(params: Dict, cfg: UNetConfig = UNetConfig(),
                           include_ip: bool = True) -> Dict:
    """Inverse of :func:`unet_params_from_state_dict`: a unet param tree as
    a diffusers-named state dict (linears back to [out, in], as views).
    On a ``meta`` tree it gives the exact key manifest a checkpoint must
    provide."""
    sd: Dict = {}

    def put_lin(name, p):
        sd[name + ".weight"] = p["kernel"].T
        if "bias" in p:
            sd[name + ".bias"] = p["bias"]

    def put_conv(name, p):
        sd[name + ".weight"] = p["kernel"]
        sd[name + ".bias"] = p["bias"]

    def put_norm(name, p):
        sd[name + ".weight"] = p["scale"]
        sd[name + ".bias"] = p["bias"]

    def put_resnet(name, p):
        put_norm(name + ".norm1", p["norm1"])
        put_conv(name + ".conv1", p["conv1"])
        put_lin(name + ".time_emb_proj", p["time_emb_proj"])
        put_norm(name + ".norm2", p["norm2"])
        put_conv(name + ".conv2", p["conv2"])
        if "conv_shortcut" in p:
            put_conv(name + ".conv_shortcut", p["conv_shortcut"])

    def put_attn(name, p):
        for n in ("to_q", "to_k", "to_v"):
            put_lin(name + "." + n, p[n])
        put_lin(name + ".to_out.0", p["to_out"])
        if include_ip and "to_k_ip" in p:
            put_lin(name + ".to_k_ip", p["to_k_ip"])
            put_lin(name + ".to_v_ip", p["to_v_ip"])

    def put_transformer(name, p):
        put_norm(name + ".norm", p["norm"])
        put_lin(name + ".proj_in", p["proj_in"])
        for d, blk in enumerate(p["blocks"]):
            bp = f"{name}.transformer_blocks.{d}"
            put_norm(bp + ".norm1", blk["norm1"])
            put_attn(bp + ".attn1", blk["attn1"])
            put_norm(bp + ".norm2", blk["norm2"])
            put_attn(bp + ".attn2", blk["attn2"])
            put_norm(bp + ".norm3", blk["norm3"])
            put_lin(bp + ".ff.net.0.proj", blk["ff_geglu"])
            put_lin(bp + ".ff.net.2", blk["ff_out"])
        put_lin(name + ".proj_out", p["proj_out"])

    put_conv("conv_in", params["conv_in"])
    for nm in ("time_embedding", "add_embedding"):
        put_lin(f"{nm}.linear_1", params[nm]["linear_1"])
        put_lin(f"{nm}.linear_2", params[nm]["linear_2"])
    for i, block in enumerate(params["down_blocks"]):
        for j, r in enumerate(block["resnets"]):
            put_resnet(f"down_blocks.{i}.resnets.{j}", r)
        for j, a in enumerate(block["attentions"]):
            put_transformer(f"down_blocks.{i}.attentions.{j}", a)
        if "downsample" in block:
            put_conv(f"down_blocks.{i}.downsamplers.0.conv", block["downsample"])
    for j, r in enumerate(params["mid_block"]["resnets"]):
        put_resnet(f"mid_block.resnets.{j}", r)
    for j, a in enumerate(params["mid_block"]["attentions"]):
        put_transformer(f"mid_block.attentions.{j}", a)
    for i, block in enumerate(params["up_blocks"]):
        for j, r in enumerate(block["resnets"]):
            put_resnet(f"up_blocks.{i}.resnets.{j}", r)
        for j, a in enumerate(block["attentions"]):
            put_transformer(f"up_blocks.{i}.attentions.{j}", a)
        if "upsample" in block:
            put_conv(f"up_blocks.{i}.upsamplers.0.conv", block["upsample"])
    put_norm("conv_norm_out", params["conv_norm_out"])
    put_conv("conv_out", params["conv_out"])
    return sd


def export_vae_state_dict(params: Dict, cfg: VAEConfig = VAEConfig()) -> Dict:
    """Inverse of :func:`vae_params_from_state_dict` (diffusers naming).
    The VAE's attention linears are stored untransposed, so they export
    as they are."""
    sd: Dict = {}

    def put_conv(name, p):
        sd[name + ".weight"] = p["kernel"]
        sd[name + ".bias"] = p["bias"]

    def put_norm(name, p):
        sd[name + ".weight"] = p["scale"]
        sd[name + ".bias"] = p["bias"]

    def put_resnet(name, p):
        put_norm(name + ".norm1", p["norm1"])
        put_conv(name + ".conv1", p["conv1"])
        put_norm(name + ".norm2", p["norm2"])
        put_conv(name + ".conv2", p["conv2"])
        if "conv_shortcut" in p:
            put_conv(name + ".conv_shortcut", p["conv_shortcut"])

    def put_attn(name, p):
        put_norm(name + ".group_norm", p["group_norm"])
        for n in ("to_q", "to_k", "to_v"):
            sd[f"{name}.{n}.weight"] = p[n]["kernel"]
            sd[f"{name}.{n}.bias"] = p[n]["bias"]
        sd[name + ".to_out.0.weight"] = p["to_out"]["kernel"]
        sd[name + ".to_out.0.bias"] = p["to_out"]["bias"]

    def put_mid(name, p):
        put_resnet(name + ".resnets.0", p["resnets"][0])
        put_attn(name + ".attentions.0", p["attentions"][0])
        put_resnet(name + ".resnets.1", p["resnets"][1])

    enc = params["encoder"]
    put_conv("encoder.conv_in", enc["conv_in"])
    for i, block in enumerate(enc["down_blocks"]):
        for j, r in enumerate(block["resnets"]):
            put_resnet(f"encoder.down_blocks.{i}.resnets.{j}", r)
        if "downsample" in block:
            put_conv(f"encoder.down_blocks.{i}.downsamplers.0.conv", block["downsample"])
    put_mid("encoder.mid_block", enc["mid"])
    put_norm("encoder.conv_norm_out", enc["norm_out"])
    put_conv("encoder.conv_out", enc["conv_out"])
    put_conv("quant_conv", params["quant_conv"])
    put_conv("post_quant_conv", params["post_quant_conv"])
    dec = params["decoder"]
    put_conv("decoder.conv_in", dec["conv_in"])
    put_mid("decoder.mid_block", dec["mid"])
    for i, block in enumerate(dec["up_blocks"]):
        for j, r in enumerate(block["resnets"]):
            put_resnet(f"decoder.up_blocks.{i}.resnets.{j}", r)
        if "upsample" in block:
            put_conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", block["upsample"])
    put_norm("decoder.conv_norm_out", dec["norm_out"])
    put_conv("decoder.conv_out", dec["conv_out"])
    return sd


def unet_state_dict_template(cfg: UNetConfig = UNetConfig(),
                             with_ip: bool = False) -> Dict[str, torch.Tensor]:
    """{key: meta tensor} that a diffusers checkpoint must provide for
    ``cfg``, built on the meta device (no memory at any size).
    ``with_ip=False`` is the shape of a stock SDXL ``unet/`` checkpoint."""
    return export_unet_state_dict(unet_init(META_GENERATOR, cfg, with_ip=with_ip), cfg)


def vae_state_dict_template(cfg: VAEConfig = VAEConfig()) -> Dict[str, torch.Tensor]:
    """{key: meta tensor} that a diffusers ``vae/`` checkpoint must provide."""
    return export_vae_state_dict(vae_init(META_GENERATOR, cfg), cfg)


def read_state_dict_shapes(path: str) -> Dict[str, Tuple[int, ...]]:
    """Key → shape of a checkpoint file; of a ``.safetensors`` file from
    its header alone, cheap enough to gate start-up on."""
    if path.endswith(".safetensors"):
        return read_shapes(path)
    return {k: tuple(v.shape) for k, v in load_state_dict(path).items()}


def _find(directory: str, names) -> Optional[str]:
    return next((os.path.join(directory, n) for n in names
                 if os.path.exists(os.path.join(directory, n))), None)


def precheck_sdxl_checkpoint(checkpoint_dir: str, unet_cfg: UNetConfig = UNetConfig(),
                             vae_cfg: VAEConfig = VAEConfig()) -> bool:
    """Start-up gate of ``--sdxl-checkpoint``: diff the checkpoint's
    key/shape headers against the exact templates the converters expect,
    before any tensor is read.  Raises ValueError with the whole diff.

    IP-adapter keys (``to_k_ip``/``to_v_ip``) are optional: stock SDXL lacks
    them and the converter then clones to_k/to_v.  Returns whether the
    U-Net holds them: ``load_sdxl``'s ``with_ip`` that consumes every key
    and clones nothing."""
    problems = []
    has_ip = False
    for sub, template in (("unet", unet_state_dict_template(unet_cfg, with_ip=False)),
                          ("vae", vae_state_dict_template(vae_cfg))):
        d = os.path.join(checkpoint_dir, sub)
        path = _find(d, DIFFUSION_NAMES)
        if path is None:
            problems.append(f"{sub}: no weights file under {d}")
            continue
        got = read_state_dict_shapes(path)
        expect = {k: tuple(v.shape) for k, v in template.items()}
        optional = {}
        if sub == "unet":
            optional = {k: tuple(v.shape) for k, v in
                        unet_state_dict_template(unet_cfg, with_ip=True).items()
                        if k not in expect}
        known = expect | optional
        missing = sorted(set(expect) - set(got))
        extra = sorted(k for k in got if k not in known)
        bad_shape = sorted(f"{k}: got {got[k]}, want {known[k]}"
                           for k in got if k in known and got[k] != known[k])
        has_ip = has_ip or any(k in optional for k in got)
        if missing:
            problems.append(f"{sub}: {len(missing)} missing key(s), e.g. {missing[:5]}")
        if extra:
            problems.append(f"{sub}: {len(extra)} unexpected key(s), e.g. {extra[:5]}")
        if bad_shape:
            problems.append(f"{sub}: {len(bad_shape)} shape mismatch(es), "
                            f"e.g. {bad_shape[:5]}")
    if problems:
        raise ValueError(f"SDXL checkpoint precheck failed for {checkpoint_dir}:\n  "
                         + "\n  ".join(problems))
    return has_ip


def checkpoint_fingerprint(checkpoint_dir: str) -> Dict:
    """Cheap content identity of an SDXL checkpoint directory, recorded in
    a run's FORMAT.json: a trainable-only checkpoint's frozen partition is
    rebuilt from ``--sdxl-checkpoint``, so a resume or inference against
    another checkpoint must be refused.

    Hashes each weight file's relative path, byte size and first 64 KiB
    (for safetensors the whole key/shape/offset header), in the directory
    walk's sorted order — the JAX package's digest, byte for byte.
    Returns ``{"digest", "total_bytes", "n_files", "path"}``."""
    h = hashlib.sha256()
    total = n = 0
    root = os.path.abspath(checkpoint_dir)
    for dirpath, dirnames, filenames in sorted(os.walk(root)):
        dirnames.sort()
        for name in sorted(filenames):
            if not name.endswith((".safetensors", ".bin")):
                continue
            p = os.path.join(dirpath, name)
            size = os.path.getsize(p)
            h.update(os.path.relpath(p, root).encode())
            h.update(str(size).encode())
            with open(p, "rb") as f:
                h.update(f.read(65536))
            total += size
            n += 1
    return {"digest": h.hexdigest(), "total_bytes": total, "n_files": n, "path": root}


def _leaves_with_path(tree, path=""):
    """[(path, leaf)] with dict keys sorted, paths written as JAX's keystr."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_with_path(tree[k], f"{path}['{k}']")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaves_with_path(v, f"{path}[{i}]")]
    return [(path, tree)]


def assert_tree_matches(params: Dict, expect: Dict, what: str) -> None:
    """Assert that a converted tree has exactly the structure and leaf
    shapes of the init tree (``expect``, e.g. built on the meta device):
    the 'every leaf filled' half of the strict loading contract."""
    got, want = _leaves_with_path(params), _leaves_with_path(expect)
    g_paths, e_paths = [p for p, _ in got], [p for p, _ in want]
    if g_paths != e_paths:
        raise ValueError(
            f"{what}: converted tree structure differs from init — missing leaves "
            f"{sorted(set(e_paths) - set(g_paths))[:10]}, unexpected leaves "
            f"{sorted(set(g_paths) - set(e_paths))[:10]}")
    for (path, g), (_, e) in zip(got, want):
        if tuple(g.shape) != tuple(e.shape):
            raise ValueError(f"{what}: leaf {path} has shape {tuple(g.shape)}, "
                             f"expected {tuple(e.shape)}")


# ---------------------------------------------------------------------------
# checkpoint directory entry point
# ---------------------------------------------------------------------------

def load_sdxl(checkpoint_dir: str, *, with_ip: bool = True,
              with_text_encoders: bool = True, unet_cfg: UNetConfig = UNetConfig(),
              vae_cfg: VAEConfig = VAEConfig(), text_cfg_1=None, text_cfg_2=None,
              strict: bool = True, device=None) -> Dict:
    """VAE + U-Net (+ both CLIP text towers) of an SDXL directory in the
    HF hub layout (``vae/``, ``unet/``, ``text_encoder/``,
    ``text_encoder_2/``, each with a safetensors or bin file), as float32
    trees on ``device`` (default cuda; raises without a card).

    ``device="cpu"`` keeps the trees in host memory, a float32 file's
    leaves as views of its map: ``training.loop.build_initial_params`` then
    copies them into the card's tensors one leaf at a time, so the card
    never holds two U-Nets.

    The text towers exist only to compute the empty-prompt conditioning
    once (reference stable_diffusion/network.py:114-168); a directory
    without them gives a dict without those keys.  ``strict`` (default on):
    every state-dict key must be consumed and every converted tree must
    match the init tree leaf for leaf, shapes included."""
    dev = resolve_device(device)

    def find_weights(sub, names):
        path = _find(os.path.join(checkpoint_dir, sub), names)
        return None if path is None else load_state_dict(path)

    vae_sd = find_weights("vae", DIFFUSION_NAMES)
    unet_sd = find_weights("unet", DIFFUSION_NAMES)
    if vae_sd is None or unet_sd is None:
        raise FileNotFoundError(f"no vae/unet weights found under {checkpoint_dir}")
    out = {"vae": vae_params_from_state_dict(vae_sd, vae_cfg, strict=strict, device=dev)}
    del vae_sd
    out["unet"] = unet_params_from_state_dict(unet_sd, unet_cfg, with_ip=with_ip,
                                              strict=strict, device=dev)
    del unet_sd
    if strict:
        assert_tree_matches(out["vae"], vae_init(META_GENERATOR, vae_cfg), "VAE")
        assert_tree_matches(out["unet"], unet_init(META_GENERATOR, unet_cfg,
                                                   with_ip=with_ip), "U-Net")
    if with_text_encoders:
        from .clip_text import clip_l_config, open_clip_bigg_config, params_from_hf_state_dict

        for key, cfg in (("text_encoder", text_cfg_1 or clip_l_config()),
                         ("text_encoder_2", text_cfg_2 or open_clip_bigg_config())):
            sd = find_weights(key, TEXT_NAMES)
            if sd is not None:
                out[key] = params_from_hf_state_dict(sd, cfg, strict=strict, device=dev)
    return out
