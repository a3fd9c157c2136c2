"""The port's weight loading (models/diffusion/weights.py and
utils/safetensors.py) against the JAX package's and the ``safetensors``
package, on the CPU.

The safetensors reader and writer must read what the package writes and
write what it reads, bit for bit (F32, F16, BF16, I64).  The converters
take the same numpy state dicts as the JAX converters, exported from
seeded tiny trees (the port's init: JAX's eager init of a tiny U-Net
takes ~20 s on the CPU), and must give equal float32 leaves, bit for bit.  The
full-size templates, built on the meta device, must equal the committed
manifests.  ``checkpoint_fingerprint`` must give the JAX function's digest
on the same directory.
"""

import json
import os

import jax
import numpy as np
import pytest
import safetensors.torch
import torch

import chip_smoke
from stable_nerf_tpu.models.diffusion import clip_text as jclip
from stable_nerf_tpu.models.diffusion import weights as jw
from stable_nerf_tpu.models.diffusion.unet import tiny_unet_config as j_tiny_unet
from stable_nerf_tpu.models.diffusion.vae import VAEConfig as JVAEConfig
from stable_nerf_tpu_torch.models.diffusion import clip_text as tclip
from stable_nerf_tpu_torch.models.diffusion import weights as tw
from stable_nerf_tpu_torch.models.diffusion.unet import (sdxl_unet_config, tiny_unet_config,
                                                         unet_init)
from stable_nerf_tpu_torch.models.diffusion.vae import VAEConfig, vae_init
from stable_nerf_tpu_torch.utils import safetensors as st
from stable_nerf_tpu_torch.utils.tree import tree_leaves

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
TINY_VAE = VAEConfig(block_out_channels=(16, 32), layers_per_block=1, norm_groups=8)
J_TINY_VAE = JVAEConfig(block_out_channels=(16, 32), layers_per_block=1, norm_groups=8)
TINY_TEXT = dict(vocab_size=64, hidden_size=16, num_layers=2, num_heads=2,
                 intermediate_size=32, max_positions=77)


def _np(sd):
    return {k: v.numpy().copy() for k, v in sd.items()}


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _unet_sd(seed, with_ip):
    tree = unet_init(_gen(seed), tiny_unet_config(), with_ip=with_ip)
    sd = _np(tw.export_unet_state_dict(tree))
    want = jw.export_unet_state_dict(jax.tree.map(np.asarray, tree), j_tiny_unet())
    assert list(sd) == list(want)          # the exporters agree, key order included
    return sd


def _vae_sd(seed):
    return _np(tw.export_vae_state_dict(vae_init(_gen(seed), TINY_VAE), TINY_VAE))


def _text_sd(seed, projection):
    cfg = tclip.CLIPTextConfig(**TINY_TEXT, projection_dim=8 if projection else 0)
    return _np(chip_smoke.clip_text_state_dict(tclip.clip_text_init(seed, cfg, device="cpu")))


def _assert_trees_equal(port, ref):
    """The port's tree equals the JAX tree leaf for leaf, bit for bit."""
    got = tw._leaves_with_path(port)
    want = [(jax.tree_util.keystr(p), x) for p, x in jax.tree.leaves_with_path(ref)]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == torch.float32, path
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=path)


def _write_dir(root, unet_sd, vae_sd, text=False):
    parts = {"unet": unet_sd, "vae": vae_sd}
    if text:
        parts |= {"text_encoder": _text_sd(3, False), "text_encoder_2": _text_sd(4, True)}
    chip_smoke.write_sdxl_checkpoint(str(root), parts)
    return str(root)


# --- safetensors -----------------------------------------------------------

def _tensors():
    g = torch.Generator().manual_seed(0)
    return {"w32": torch.randn(3, 5, generator=g), "h16": torch.randn(7, generator=g).half(),
            "b16": torch.randn(2, 3, 2, generator=g).bfloat16(),
            "i64": torch.arange(-4, 5), "empty": torch.zeros(0, 4), "scalar": torch.tensor(2.5)}


@pytest.mark.parametrize("writer", ["port", "package"])
def test_safetensors_reads_and_writes_as_the_package(tmp_path, writer):
    tensors, path = _tensors(), str(tmp_path / "x.safetensors")
    if writer == "port":
        st.save_file(tensors, path, metadata={"format": "pt"})
        got = safetensors.torch.load_file(path)
    else:
        safetensors.torch.save_file(tensors, path, metadata={"format": "pt"})
        got = st.load_file(path)
    assert set(got) == set(tensors)
    for k, t in tensors.items():
        assert got[k].dtype == t.dtype and got[k].shape == t.shape, k
        assert torch.equal(got[k], t), k
    assert st.read_shapes(path) == {k: tuple(t.shape) for k, t in tensors.items()}


def test_safetensors_header_alone_maps_and_casts(tmp_path):
    path = str(tmp_path / "x.safetensors")
    st.save_file({"a": torch.arange(6.0).reshape(2, 3), "b": torch.ones(4)}, path,
                 dtype=torch.float16)
    loaded = st.load_file(path)
    assert loaded["a"].dtype == torch.float16 and loaded["a"].tolist() == [[0, 1, 2], [3, 4, 5]]
    # a float32 file's leaves convert without a copy
    st.save_file({"c": torch.ones(3, 2)}, str(tmp_path / "f32.safetensors"))
    c = st.load_file(str(tmp_path / "f32.safetensors"))["c"]
    assert tw._to_f32(c).data_ptr() == c.data_ptr()
    # shapes come from the header alone: a file cut after it still reads
    header_len = 8 + int.from_bytes(open(path, "rb").read(8), "little")
    with open(path, "r+b") as f:
        f.truncate(header_len)
    assert st.read_shapes(path) == {"a": (2, 3), "b": (4,)}
    with pytest.raises(ValueError, match="offsets"):
        st.load_file(path)


# --- converters ------------------------------------------------------------

def test_vae_converter_and_exporter_equal_jax():
    sd = _vae_sd(2)
    port = tw.vae_params_from_state_dict(sd, TINY_VAE, strict=True)
    _assert_trees_equal(port, jw.vae_params_from_state_dict(sd, J_TINY_VAE, strict=True))
    back = tw.export_vae_state_dict(port, TINY_VAE)
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)


@pytest.mark.parametrize("ip_in_checkpoint,with_ip", [(False, True), (True, True),
                                                       (False, False)])
def test_unet_converter_and_exporter_equal_jax(ip_in_checkpoint, with_ip):
    sd = _unet_sd(0, ip_in_checkpoint)
    port = tw.unet_params_from_state_dict(sd, tiny_unet_config(), with_ip=with_ip,
                                          strict=True)
    _assert_trees_equal(port, jw.unet_params_from_state_dict(sd, j_tiny_unet(),
                                                             with_ip=with_ip, strict=True))
    attn2 = port["down_blocks"][1]["attentions"][0]["blocks"][0]["attn2"]
    if with_ip and not ip_in_checkpoint:
        # the IP heads are clones of to_k/to_v, never the same memory
        assert torch.equal(attn2["to_k_ip"]["kernel"], attn2["to_k"]["kernel"])
        assert attn2["to_k_ip"]["kernel"].data_ptr() != attn2["to_k"]["kernel"].data_ptr()
    back = tw.export_unet_state_dict(port, tiny_unet_config(), include_ip=ip_in_checkpoint)
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)


def test_strict_converters_name_unconsumed_and_missing_keys():
    sd = _unet_sd(0, True)
    sd["down_blocks.0.attn_extra.weight"] = np.zeros((4, 4), np.float32)
    with pytest.raises(ValueError, match="not consumed.*attn_extra"):
        tw.unet_params_from_state_dict(sd, tiny_unet_config(), strict=True)
    sd = _unet_sd(0, True)
    del sd["mid_block.resnets.0.conv1.weight"]
    with pytest.raises(KeyError, match="mid_block.resnets.0.conv1.weight"):
        tw.unet_params_from_state_dict(sd, tiny_unet_config())
    sd = _vae_sd(1)
    sd["encoder.extra.bias"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="VAE: 1 checkpoint key"):
        tw.vae_params_from_state_dict(sd, TINY_VAE, strict=True)
    port = tw.vae_params_from_state_dict(_vae_sd(1), TINY_VAE)
    port["quant_conv"]["kernel"] = torch.zeros(1, 1, 1, 1)
    with pytest.raises(ValueError, match=r"\['quant_conv'\]\['kernel'\] has shape"):
        tw.assert_tree_matches(port, tw.vae_init(tw.META_GENERATOR, TINY_VAE), "VAE")


@pytest.mark.parametrize("what,cfg,fixture,n_keys,n_params", [
    ("unet", sdxl_unet_config(), "sdxl_unet_keys.json", 1680, 2_567_463_684),
    ("vae", VAEConfig(), "sdxl_vae_keys.json", 248, 83_653_863),
])
def test_full_size_templates_on_meta_equal_the_manifests(what, cfg, fixture, n_keys,
                                                         n_params):
    template = (tw.unet_state_dict_template(cfg) if what == "unet"
                else tw.vae_state_dict_template(cfg))
    assert all(t.is_meta for t in template.values())
    manifest = json.load(open(os.path.join(FIXTURES, fixture)))
    assert {k: list(t.shape) for k, t in template.items()} == manifest
    assert len(manifest) == n_keys
    assert sum(t.numel() for t in template.values()) == n_params


# --- directories: precheck, fingerprint, load_sdxl --------------------------

@pytest.mark.parametrize("case", ["clean", "ip_extra", "missing_and_bad_shape", "empty"])
def test_precheck_agrees_with_jax(tmp_path, case):
    unet_sd, vae_sd = _unet_sd(0, case == "ip_extra"), _vae_sd(1)
    if case == "missing_and_bad_shape":
        del unet_sd["conv_out.bias"]
        vae_sd["quant_conv.weight"] = np.zeros((3, 3, 1, 1), np.float32)
    if case != "empty":
        _write_dir(tmp_path, unet_sd, vae_sd)
    results = []
    for mod, ucfg, vcfg in ((tw, tiny_unet_config(), TINY_VAE),
                            (jw, j_tiny_unet(), J_TINY_VAE)):
        try:
            has_ip = mod.precheck_sdxl_checkpoint(str(tmp_path), unet_cfg=ucfg, vae_cfg=vcfg)
            results.append(None)
        except ValueError as e:
            results.append(str(e))
        if mod is tw and results[0] is None:
            # the port also says whether the U-Net holds the IP heads
            assert has_ip is (case == "ip_extra")
    assert results[0] == results[1]
    if case in ("clean", "ip_extra"):
        assert results[0] is None
    elif case == "empty":
        assert "no weights file" in results[0]
    else:
        assert "missing" in results[0] and "conv_out.bias" in results[0]
        assert "shape mismatch" in results[0] and "quant_conv.weight" in results[0]


def test_fingerprint_digest_equals_jax(tmp_path):
    root = _write_dir(tmp_path / "ckpt", _unet_sd(0, False), _vae_sd(1), text=True)
    (tmp_path / "ckpt" / "unet" / "config.json").write_text("{}")   # not hashed
    got, want = tw.checkpoint_fingerprint(root), jw.checkpoint_fingerprint(root)
    assert got == want and got["n_files"] == 4
    before = got["digest"]
    chip_smoke.write_sdxl_checkpoint(root, {"vae": _vae_sd(5)}, dtype=torch.float16)
    assert tw.checkpoint_fingerprint(root)["digest"] != before


def test_load_sdxl_equals_jax_and_refuses_a_bad_directory(tmp_path):
    root = _write_dir(tmp_path / "ckpt", _unet_sd(0, False), _vae_sd(1), text=True)
    t1 = tclip.CLIPTextConfig(**TINY_TEXT)
    t2 = tclip.CLIPTextConfig(**TINY_TEXT, projection_dim=8, hidden_act="gelu", pad_token_id=0)
    port = tw.load_sdxl(root, unet_cfg=tiny_unet_config(), vae_cfg=TINY_VAE,
                        text_cfg_1=t1, text_cfg_2=t2, device="cpu")
    ref = jw.load_sdxl(root, unet_cfg=j_tiny_unet(), vae_cfg=J_TINY_VAE,
                       text_cfg_1=jclip.CLIPTextConfig(**TINY_TEXT),
                       text_cfg_2=jclip.CLIPTextConfig(**TINY_TEXT, projection_dim=8))
    assert set(port) == set(ref) == {"vae", "unet", "text_encoder", "text_encoder_2"}
    for k in port:
        _assert_trees_equal(port[k], ref[k])
    assert len(tree_leaves(port["text_encoder_2"])) == len(tree_leaves(port["text_encoder"])) + 1
    with pytest.raises(FileNotFoundError, match="no vae/unet weights"):
        tw.load_sdxl(str(tmp_path), device="cpu")
