"""scripts/run_torch_sd.py and scripts/validate_torch_sdxl_checkpoint.py on
the CPU, against the JAX package at the tiny size.

* run_torch_sd's denoise body (3 DDIM steps, float32, the tiny stack of
  ``--tiny``) from the port's params converted to JAX's layout and the same
  start latents, against run_sd.py's body (a jitted ``lax.scan`` of
  ``sd_forward`` and the DDIM step).  Tolerance 1e-4 of the latents'
  largest magnitude: float32 sums in other orders through three U-Net
  passes.
* The validator's and the denoise profile's SDXL loop
  (``torch_study.sdxl_eps`` through ``DDIMScheduler.denoise``) on the tiny
  U-Net at float32, batches 1 and 2, pooled embeds zero and drawn,
  against the inline JAX loop of bench.py and validate_sdxl_checkpoint.py;
  1e-5 of the latents' largest magnitude.
* The VAE round trips of both scripts with JAX's own normal draw injected:
  the latent's statistics, the reconstruction's MSE and PSNR.  Tolerance
  3e-5 of the latent's largest magnitude (XLA's float32 VAE strays ~2e-5
  of the largest magnitude from a float64 run, the port ~1e-6); the PSNR
  to 1e-3 dB; the report's rounded values to one unit of their last place
  beyond that.
* ``tree_checksum`` on the same tiny tree gives the JAX validator's record
  exactly: leaf count, parameter count, L2 and SHA-256 of the float32
  bytes in JAX's leaf order.
* The validator's control flow on tiny trees (every check run and
  reported, random weights failing only the reconstruction check), and
  run_torch_sd's: outputs written, ``--sp``/``--tp`` refused with one
  device (tests/test_torch_run_sd_sharded.py runs them on several
  processes), ``--image`` decoded natively.
"""

import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from stable_nerf_tpu.config import SDConfig as JSDConfig
from stable_nerf_tpu.models.diffusion import DDIMScheduler as JDDIMScheduler
from stable_nerf_tpu.models.diffusion import sd_network as jsd
from stable_nerf_tpu.models.diffusion import unet as junet
from stable_nerf_tpu.models.diffusion import vae as jvae
from stable_nerf_tpu.models.diffusion.unet import tiny_unet_config as jtiny_unet
from stable_nerf_tpu.utils.losses import psnr as jpsnr
from stable_nerf_tpu_torch import convert
from stable_nerf_tpu_torch.models.diffusion import clip_text as tclip
from stable_nerf_tpu_torch.models.diffusion.scheduler import DDIMScheduler
from stable_nerf_tpu_torch.models.diffusion.sd_network import (init_ip_from_unet,
                                                               sd_network_init)
from stable_nerf_tpu_torch.models.diffusion.unet import tiny_unet_config, unet_init
from stable_nerf_tpu_torch.models.diffusion.vae import VAEConfig, vae_init

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
# tiny towers in SDXL's configurations: CLIP-L 12 heads × 2, bigG 20 heads × 2
TOWERS = (tclip.CLIPTextConfig(hidden_size=24, num_layers=12, intermediate_size=16),
          tclip.CLIPTextConfig(hidden_size=40, num_layers=32, num_heads=20,
                               intermediate_size=16, hidden_act="gelu", projection_dim=32,
                               pad_token_id=0))
TINY_VAE = dict(block_out_channels=(16, 32), layers_per_block=1, norm_groups=8)


def _script(name):
    if SCRIPTS not in sys.path:
        sys.path.insert(0, SCRIPTS)
    spec = importlib.util.spec_from_file_location(name, os.path.join(SCRIPTS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def run_sd():
    return _script("run_torch_sd")


@pytest.fixture(scope="module")
def validator():
    return _script("validate_torch_sdxl_checkpoint")


@pytest.fixture(scope="module")
def tiny(run_sd):
    """run_sd.py --tiny's configs in both packages and the port's params
    (seed 0, IP heads from to_k/to_v) with their JAX-layout copy."""
    cfg = run_sd.network_config(True, 512)
    jcfg = jsd.SDNetworkConfig(sd=JSDConfig(cross_attention_dim=48, latent_size=32,
                                            image_size=64),
                               unet=jtiny_unet(), vae=jvae.VAEConfig(**TINY_VAE))
    params = init_ip_from_unet(sd_network_init(0, cfg, device="cpu"))
    return cfg, jcfg, params, convert.params_to_jax(params)


def _scale_close(got, want, tol):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-6), err


def test_denoise_body_equals_run_sd(run_sd, tiny):
    cfg, jcfg, params, jparams = tiny
    n_steps = 3
    g = np.random.default_rng(0)
    latents = g.standard_normal((1, 4, 32, 32)).astype(np.float32)
    enc = cfg.sd.latent_size
    cond = np.zeros((2, cfg.sd.cond_channels, enc, enc), np.float32)

    got = run_sd.denoise(params, torch.from_numpy(latents), torch.from_numpy(cond), cfg,
                         DDIMScheduler.create(cfg.scheduler, device="cpu"), n_steps,
                         compute_dtype=torch.float32)

    scheduler = JDDIMScheduler.create(jcfg.scheduler)
    ts = jnp.asarray(scheduler.timesteps(n_steps))

    @jax.jit
    def denoise_local(params, latents):
        def body(x, t):
            eps = jsd.sd_forward(params, x, t, jnp.asarray(cond), jcfg,
                                 compute_dtype=jnp.float32)
            x, _ = scheduler.step(eps, t, x, num_inference_steps=n_steps)
            return x, None
        out, _ = jax.lax.scan(body, latents, ts)
        return out

    want = denoise_local(jparams, jnp.asarray(latents))
    _scale_close(got.numpy(), want, 1e-4)


@pytest.mark.parametrize("pooled", ["zeros", "drawn"])
@pytest.mark.parametrize("batch", [1, 2])
def test_sdxl_denoise_equals_jax(batch, pooled):
    """The validator's and the denoise profile's SDXL loop
    (``torch_study.sdxl_eps`` through ``DDIMScheduler.denoise``: zero IP
    tokens, the pooled embeds or zeros, the SDXL time ids at 1024) on the
    tiny U-Net with IP heads, 3 DDIM steps at float32, against the loop of
    bench.py and validate_sdxl_checkpoint.py (a jitted ``lax.scan`` of
    ``unet_apply`` and the DDIM step) from the converted params.
    Tolerance 1e-5 of the latents' largest magnitude: float32 sums in
    other orders through three U-Net passes (at most 3.4e-7 measured)."""
    study = _script("torch_study")
    cfg, jcfg, n_steps = tiny_unet_config(), jtiny_unet(), 3
    params = unet_init(torch.Generator().manual_seed(3), cfg, with_ip=True)
    g = np.random.default_rng(batch)
    latents = g.standard_normal((batch, 4, 16, 16)).astype(np.float32)
    embeds = (np.zeros((batch, cfg.pooled_projection_dim), np.float32) if pooled == "zeros"
              else g.standard_normal((batch, cfg.pooled_projection_dim)).astype(np.float32))

    eps = study.sdxl_eps(params, cfg, batch, "cpu",
                         pooled=None if pooled == "zeros" else torch.from_numpy(embeds),
                         compute_dtype=torch.float32)
    got = DDIMScheduler.create(device="cpu").denoise(eps, torch.from_numpy(latents), n_steps)

    scheduler = JDDIMScheduler.create()
    ip_tokens = jnp.zeros((batch, 4, jcfg.cross_attention_dim), jnp.float32)
    time_ids = jnp.broadcast_to(
        jnp.asarray([[1024.0, 1024.0, 0.0, 0.0, 1024.0, 1024.0]]), (batch, 6))
    ts = jnp.asarray(scheduler.timesteps(n_steps))

    @jax.jit
    def denoise(params, pooled, latents):
        def body(x, t):
            eps = junet.unet_apply(params, x, t, ip_tokens, added_text_embeds=pooled,
                                   added_time_ids=time_ids, cfg=jcfg,
                                   compute_dtype=jnp.float32)
            x, _ = scheduler.step(eps, t, x, num_inference_steps=n_steps)
            return x, None
        out, _ = jax.lax.scan(body, latents, ts)
        return out

    want = denoise(convert.params_to_jax(params), jnp.asarray(embeds), jnp.asarray(latents))
    _scale_close(got.numpy(), want, 1e-5)


def test_run_sd_vae_round_trip_stats_equal_jax(run_sd, tiny):
    cfg, jcfg, params, jparams = tiny
    x = np.random.default_rng(1).uniform(-1, 1, (1, 3, 64, 64)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    eps = np.array(jax.random.normal(key, (1, 4, 32, 32), jnp.float32))
    lat, recon, stats = run_sd.vae_round_trip(params, torch.from_numpy(x), cfg,
                                              eps=torch.from_numpy(eps))
    jlat = jsd.encode_images(jparams, jnp.asarray(x), key, jcfg)
    jrecon = jsd.decode_latents(jparams, jlat, jcfg)
    _scale_close(lat.numpy(), jlat, 3e-5)
    _scale_close(recon.numpy(), jrecon, 3e-5)
    scale = float(jnp.abs(jlat).max())
    for name, want in (("latent_mean", jlat.mean()), ("latent_std", jlat.std()),
                       ("latent_min", jlat.min()), ("latent_max", jlat.max())):
        assert abs(stats[name] - float(want)) <= 3e-5 * scale, name
    want_mse = float(jnp.mean((jrecon - x) ** 2))
    assert abs(stats["recon_mse"] - want_mse) <= 1e-4 * want_mse


def test_validator_vae_round_trip_equals_jax(validator):
    vcfg, jcfg = VAEConfig(**TINY_VAE), jvae.VAEConfig(**TINY_VAE)
    vae = vae_init(torch.Generator().manual_seed(3), vcfg)
    jv = convert.params_to_jax(vae)
    img = validator.test_image(64)
    key = jax.random.PRNGKey(0)
    eps = np.array(jax.random.normal(key, (1, 4, 32, 32), jnp.float32))
    _, _, got = validator.vae_round_trip(vae, torch.from_numpy(img), vcfg,
                                         eps=torch.from_numpy(eps))
    lat = jvae.vae_encode_sample(jv, jnp.asarray(img), key, jcfg)
    rec = jvae.vae_decode(jv, lat, jcfg)
    want_psnr = float(jpsnr(jnp.clip((rec + 1) / 2, 0, 1), jnp.clip((img + 1) / 2, 0, 1))[0, 0])
    assert got["latent_shape"] == list(lat.shape)
    scale = float(jnp.abs(lat).max())
    assert abs(got["latent_mean"] - float(lat.mean())) <= 5e-5 + 3e-5 * scale
    assert abs(got["latent_std"] - float(lat.std())) <= 5e-5 + 3e-5 * scale
    assert abs(got["reconstruction_psnr_db"] - want_psnr) <= 5e-3 + 1e-3


def test_tree_checksum_equals_the_jax_validators(validator):
    jax_validator = _script("validate_sdxl_checkpoint")
    g = torch.Generator().manual_seed(5)
    tree = {"unet": unet_init(g, tiny_unet_config(), with_ip=True),
            "vae": vae_init(g, VAEConfig(**TINY_VAE)),
            "text_encoder": tclip.clip_text_init(6, TOWERS[0], device="cpu")}
    for name, sub in tree.items():
        got = validator.tree_checksum(sub)
        want = jax_validator.tree_checksum(convert.params_to_jax(sub))
        assert got == want, name
    # a bf16 tree sums its float32 values, as JAX's np.asarray(leaf, f32)
    half = {k: v.to(torch.bfloat16) for k, v in tree["unet"]["conv_in"].items()}
    assert validator.tree_checksum(half) == jax_validator.tree_checksum(
        {k: jnp.asarray(v.float().numpy(), jnp.bfloat16) for k, v in half.items()})


def test_validator_runs_every_check_and_reports_the_failures(validator, tmp_path,
                                                             monkeypatch, capsys):
    """main() on tiny seeded trees (load_sdxl and the SDXL configs replaced
    by tiny ones): every check runs, report.json carries the JAX
    validator's keys and ``failed_checks``, and a random VAE fails the
    reconstruction check alone, so main exits 1."""
    from stable_nerf_tpu_torch.models.diffusion import unet as tunet
    from stable_nerf_tpu_torch.models.diffusion import vae as tvae
    from stable_nerf_tpu_torch.models.diffusion import weights as tw

    g = torch.Generator().manual_seed(7)
    tree = {"vae": vae_init(g, VAEConfig(**TINY_VAE)),
            "unet": unet_init(g, tiny_unet_config(), with_ip=True),
            "text_encoder": tclip.clip_text_init(8, TOWERS[0], device="cpu"),
            "text_encoder_2": tclip.clip_text_init(9, TOWERS[1], device="cpu")}
    sums = {k: validator.tree_checksum(v) for k, v in tree.items()}
    monkeypatch.setattr(tw, "load_sdxl", lambda *a, **kw: dict(tree))
    monkeypatch.setattr(tunet, "sdxl_unet_config", tiny_unet_config)
    monkeypatch.setattr(tvae, "VAEConfig", lambda: VAEConfig(**TINY_VAE))
    cond = tclip.make_empty_prompt_conditioning
    monkeypatch.setattr(tclip, "make_empty_prompt_conditioning",
                        lambda a, b: cond(a, b, TOWERS[0], TOWERS[1]))
    # a 64² card: the tiny VAE's attention at 512² would hold 2^32 scores
    card = validator.test_image
    monkeypatch.setattr(validator, "test_image", lambda size=512: card(64))
    out = tmp_path / "val"
    assert validator.main(["--checkpoint", "unused", "--device", "cpu", "--steps", "2",
                           "--out", str(out)]) == 1
    report = json.loads((out / "report.json").read_text())
    assert set(report) == {"checksum/unet", "checksum/vae", "checksum/text_encoder",
                           "checksum/text_encoder_2", "vae", "empty_prompt", "denoise",
                           "failed_checks"}
    assert report["failed_checks"] == ["vae_reconstruction_psnr"]
    assert all(report[f"checksum/{k}"] == v for k, v in sums.items())
    assert report["vae"]["latent_shape"] == [1, 4, 32, 32]
    assert report["empty_prompt"]["pooled_norm"] > 0
    assert report["denoise"]["finite"] and report["denoise"]["image_std"] > 0.01
    assert "CHECKS FAILED: ['vae_reconstruction_psnr']" in capsys.readouterr().out


def test_run_sd_tiny_on_the_cpu_and_its_refusals(run_sd, tmp_path, capsys):
    out = tmp_path / "sd"
    assert run_sd.main(["--tiny", "--steps", "2", "--device", "cpu", "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert "VAE reconstruction MSE" in text and "steady-state" in text
    names = sorted(os.listdir(out))
    assert [n.split(".png")[0] for n in names] == ["denoised", "vae_recon"]
    # one CPU process is one device: two ranks are refused before any group
    # is made (tests/test_torch_run_sd_sharded.py runs them)
    for flag in ("--sp", "--tp"):
        assert run_sd.main([flag, "2", "--device", "cpu"]) == 1
        assert "needs 2 devices, have 1" in capsys.readouterr().err


def test_run_sd_image_decodes_natively_and_resizes_bilinear(run_sd, tmp_path):
    """--image: the native PNG decode (alpha dropped) and the antialiased
    bilinear resize of data/preprocess.py, scaled to [-1, 1]."""
    from stable_nerf_tpu_torch.data.preprocess import resize_bilinear_uint8

    rgba = np.random.default_rng(2).integers(0, 256, (48, 40, 4), dtype=np.uint8)
    path = tmp_path / "in.png"
    path.write_bytes(chip_smoke.png_bytes(rgba))
    x = run_sd.load_image(str(path), 32)
    want = resize_bilinear_uint8(rgba[None, ..., :3], (32, 32))[0]
    assert tuple(x.shape) == (1, 3, 32, 32)
    np.testing.assert_array_equal(
        x[0].permute(1, 2, 0).numpy(), want.astype(np.float32) / 127.5 - 1.0)
