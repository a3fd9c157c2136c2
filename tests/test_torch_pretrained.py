"""The port's pretrained-weights path against the JAX package's, on the CPU,
at the tiny configuration (``--tiny``): ``build_initial_params`` with
``pretrained_sd``, the CLI's ``--sdxl-checkpoint`` and its refusals.

``build_initial_params`` is held against the JAX function for the whole
tree: both start from the same random init (the port's, handed to the JAX
function in place of its own), overlay the same loaded VAE and U-Net and
cache the empty-prompt conditioning of the same two text towers.  Every
leaf equal bit for bit, in its dtype, but ``add_text_embeds``: its float32
values differ by float sums in another order (≤ 2e-5) and are then rounded
to bf16, so it is held to one bf16 step (2^-7 relative).

The towers are tiny but keep the configurations that
``make_empty_prompt_conditioning`` assumes (12 heads and quick_gelu; 20
heads, gelu and a projection), SDXL's vocabulary and token ids.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from stable_nerf_tpu.config import HashGridConfig, NeRFConfig, SDConfig, TrainConfig
from stable_nerf_tpu.models.diffusion.sd_network import SDNetworkConfig
from stable_nerf_tpu.models.diffusion.unet import tiny_unet_config
from stable_nerf_tpu.models.diffusion.vae import VAEConfig
from stable_nerf_tpu.training import joint as jj
from stable_nerf_tpu.training import loop as jloop
from stable_nerf_tpu_torch import convert
from stable_nerf_tpu_torch import train as tcli
from stable_nerf_tpu_torch.models.diffusion import clip_text as tclip
from stable_nerf_tpu_torch.models.diffusion import weights as tw
from stable_nerf_tpu_torch.models.diffusion.sd_network import sd_network_init
from stable_nerf_tpu_torch.models.diffusion.unet import unet_init
from stable_nerf_tpu_torch.models.diffusion.vae import vae_init
from stable_nerf_tpu_torch.models.nerf.network import nerf_init
from stable_nerf_tpu_torch.training import loop as tloop
from stable_nerf_tpu_torch.training.checkpoints import CheckpointManager
from stable_nerf_tpu_torch.utils.tree import tree_map

torch.set_num_threads(2)
# tiny towers in SDXL's configurations: CLIP-L 12 heads × 2, bigG 20 heads × 2
TOWERS = (tclip.CLIPTextConfig(hidden_size=24, num_layers=12, intermediate_size=16),
          tclip.CLIPTextConfig(hidden_size=40, num_layers=32, num_heads=20,
                               intermediate_size=16, hidden_act="gelu", projection_dim=32,
                               pad_token_id=0))


def _jax_cfg(frozen_dtype="bfloat16"):
    """train.py --tiny at image 32 / latent 16."""
    return jj.JointConfig(
        nerf=NeRFConfig(channel_dim=4, grid_size=32, encoding_sigma=HashGridConfig(
            n_levels=4, log2_hashmap_size=12, base_resolution=4)),
        sd=SDNetworkConfig(sd=SDConfig(latent_size=16, image_size=32, cross_attention_dim=48),
                           unet=tiny_unet_config(),
                           vae=VAEConfig(block_out_channels=(16, 32), layers_per_block=1,
                                         norm_groups=8)),
        train=TrainConfig(frozen_dtype=frozen_dtype))


def _pretrained(tcfg, seed=7):
    """load_sdxl's dict for the tiny config: seeded trees other than the
    loop's init (seed 0), the U-Net with its IP heads."""
    g = torch.Generator().manual_seed(seed)
    return {"vae": vae_init(g, tcfg.sd.vae), "unet": unet_init(g, tcfg.sd.unet, with_ip=True),
            "text_encoder": tclip.clip_text_init(seed + 1, TOWERS[0], device="cpu"),
            "text_encoder_2": tclip.clip_text_init(seed + 2, TOWERS[1], device="cpu")}


def _without_ip(tree):
    """The tree without its IP heads, as ``load_sdxl(with_ip=False)`` gives
    a stock U-Net."""
    if isinstance(tree, dict):
        return {k: _without_ip(v) for k, v in tree.items() if k not in ("to_k_ip", "to_v_ip")}
    if isinstance(tree, list):
        return [_without_ip(v) for v in tree]
    return tree


def test_build_initial_params_with_pretrained_equals_jax(monkeypatch):
    """The JAX function gets the U-Net with IP heads (its CLI loads with
    ``with_ip=True``); the port's, with and without them (its CLI loads a
    stock checkpoint without): both give the JAX tree."""
    jcfg = _jax_cfg()
    tcfg = convert.config_from_jax(jcfg)
    init_sd = sd_network_init(0, tcfg.sd, device="cpu")
    init_nerf = nerf_init(1, tcfg.nerf, device="cpu")
    # the JAX function starts from the port's random init
    monkeypatch.setattr(jloop, "sd_network_init", lambda k, cfg: jax.tree.map(
        jnp.asarray, convert.params_to_jax(init_sd)))
    monkeypatch.setattr(jloop, "nerf_init", lambda k, cfg: jax.tree.map(
        jnp.asarray, convert.params_to_jax(init_nerf)))
    monkeypatch.setattr(tloop, "sd_network_init", lambda seed, cfg, device, **cond: {
        **tree_map(torch.clone, init_sd), **cond})
    monkeypatch.setattr(tloop, "nerf_init", lambda seed, cfg, device: init_nerf)
    pre = _pretrained(tcfg)
    want = jloop.build_initial_params(jcfg, None, None, jax.tree.map(
        jnp.asarray, convert.params_to_jax(pre)), log_fn=lambda m: None)
    want_l = [(jax.tree_util.keystr(p), x) for p, x in jax.tree.leaves_with_path(want)]
    for port_pre in ({**pre, "unet": _without_ip(pre["unet"])}, pre):
        logs = []
        got = tloop.build_initial_params(tcfg, 0, 1, port_pre, device="cpu",
                                         log_fn=logs.append)
        assert any("empty-prompt conditioning" in m for m in logs)
        got_l = tw._leaves_with_path(got)
        assert [p for p, _ in got_l] == [p for p, _ in want_l]
        n_bf16 = 0
        for (path, a), (_, b) in zip(got_l, want_l):
            b = np.asarray(b)
            assert str(a.dtype).split(".")[-1] == b.dtype.name, path
            a = a.float().numpy()
            b = b.astype(np.float32)
            n_bf16 += "to_k_ip" not in path and "unet" in path
            if path == "['sd']['add_text_embeds']":
                np.testing.assert_allclose(a, b, rtol=2 ** -7, atol=0)
            else:
                np.testing.assert_array_equal(a, b, err_msg=path)
    # the overlay happened: the loaded weights, not the seed-0 init
    unet_conv = got["sd"]["unet"]["conv_in"]["kernel"]
    assert unet_conv.dtype == torch.bfloat16
    assert torch.equal(unet_conv, pre["unet"]["conv_in"]["kernel"].bfloat16())
    assert not torch.equal(unet_conv, init_sd["unet"]["conv_in"]["kernel"].bfloat16())
    # the trainable IP heads start from the loaded to_k, in float32
    path = lambda t: t["unet"]["down_blocks"][1]["attentions"][0]["blocks"][0]["attn2"]
    assert torch.equal(path(got["sd"])["to_k_ip"]["kernel"], path(pre)["to_k"]["kernel"])
    assert n_bf16 > 100


def test_build_initial_params_refuses_a_mismatched_overlay():
    tcfg = convert.config_from_jax(_jax_cfg(None))
    pre = _pretrained(tcfg)
    pre["vae"]["quant_conv"]["kernel"] = torch.zeros(1, 1, 1, 1)
    with pytest.raises(ValueError, match="quant_conv/kernel"):
        tloop.build_initial_params(tcfg, 0, 1, pre, device="cpu")
    pre = _pretrained(tcfg)
    del pre["unet"]["conv_out"]
    with pytest.raises(KeyError, match="unet"):
        tloop.build_initial_params(tcfg, 0, 1, pre, device="cpu")
    with pytest.raises(KeyError, match="'clip_vision'"):
        tloop.build_initial_params(tcfg, 0, 1, {"clip_vision": {}}, device="cpu")


def _trainable_only_workdir(root, fmt):
    ckpt = CheckpointManager(os.path.join(root, "checkpoints"))
    ckpt.write_format({"version": 2, "trainable_only": True, "seed": 0,
                       "frozen_dtype": "bfloat16", "trainable_scope": "reference", **fmt})
    open(os.path.join(ckpt.directory, "1.pt"), "wb").close()
    return str(root)


@pytest.mark.parametrize("recorded,given,words", [
    ({"pretrained_sd": True, "sdxl_fingerprint": "abc"}, None,
     "was trained WITH --sdxl-checkpoint; pass the matching flag so the frozen "
     "partition can be reconstructed"),
    ({"pretrained_sd": False, "sdxl_fingerprint": None}, {"digest": "abc"},
     "was trained WITHOUT --sdxl-checkpoint; pass the matching flag so the frozen "
     "partition can be reconstructed"),
    ({"pretrained_sd": True, "sdxl_fingerprint": "abc", "sdxl_checkpoint_path": "/w"},
     {"digest": "def"}, "was trained against SDXL checkpoint digest abc (path /w); this "
                        "run's --sdxl-checkpoint has digest def — the frozen partition "
                        "would be rebuilt from the wrong file"),
], ids=["with_vs_without", "without_vs_with", "another_digest"])
def test_cli_inference_refuses_another_sdxl_checkpoint(tmp_path, recorded, given, words):
    """The root train.py's refusals, in its words."""
    workdir = _trainable_only_workdir(tmp_path, recorded)
    tcfg = convert.config_from_jax(_jax_cfg())
    pretrained = None if given is None else {}
    with pytest.raises(SystemExit) as e:
        tcli.run_inference(tcfg, None, workdir, pretrained=pretrained, fingerprint=given,
                           device="cpu")
    assert str(e.value.code) == f"checkpoint {workdir} {words}"


def test_cli_trains_and_serves_objaverse_with_an_sdxl_checkpoint(tmp_path, capsys):
    """python -m stable_nerf_tpu_torch.train --tiny --dataset objaverse
    --sdxl-checkpoint DIR for one epoch, then --inference, on the CPU; a
    bad checkpoint directory is refused before anything loads."""
    tcfg = tcli.build_config(tcli.build_parser().parse_args(
        ["--tiny", "--image-size", "32", "--latent-size", "16"]))
    pre = _pretrained(tcfg)
    ckpt = str(tmp_path / "sdxl")
    chip_smoke.write_sdxl_checkpoint(ckpt, {
        "unet": tw.export_unet_state_dict(pre["unet"], include_ip=False),
        "vae": tw.export_vae_state_dict(pre["vae"]),
        "text_encoder": chip_smoke.clip_text_state_dict(pre["text_encoder"]),
        "text_encoder_2": chip_smoke.clip_text_state_dict(pre["text_encoder_2"])},
        dtype=torch.float16)
    data = tmp_path / "datasets"
    chip_smoke.write_objaverse(str(data), n_objects=3, size=32)
    workdir = str(tmp_path / "run")
    argv = ["--tiny", "--image-size", "32", "--latent-size", "16", "--dataset", "objaverse",
            "--data-root", str(data), "--percent-objects", "1", "--sdxl-checkpoint", ckpt,
            "--frozen-bf16", "--checkpoint-trainable-only", "--epochs", "1", "--max-steps",
            "16", "--num-inference-steps", "2", "--workdir", workdir, "--device", "cpu"]
    tcli.main(argv)
    fmt = json.load(open(os.path.join(workdir, "checkpoints", "FORMAT.json")))
    assert fmt["pretrained_sd"] is True
    assert fmt["sdxl_fingerprint"] == tw.checkpoint_fingerprint(ckpt)["digest"]
    tcli.main(argv + ["--inference"])
    out = capsys.readouterr().out
    assert "dataset: 3 paired samples" in out and "Average L2 over test set" in out
    assert any(f.startswith("denoised_0_0") for f in os.listdir(os.path.join(workdir,
                                                                             "renders")))
    os.remove(os.path.join(ckpt, "vae", "diffusion_pytorch_model.safetensors"))
    with pytest.raises(ValueError, match="(?s)precheck failed.*vae: no weights file"):
        tcli.main(argv + ["--workdir", str(tmp_path / "other")])
