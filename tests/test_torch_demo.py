"""The learned-diffusion demo in the port against the JAX package on the
CPU: ``demo_unet_config`` and ``sd_forward`` at its size, the tiny-VAE
artifact (``vae_save_npz`` / ``vae_load_npz``) both ways, the committed
JAX-trained ``runs/demo_vae/vae.npz``, the CLI's ``--demo`` branch, and one
demo ``forward_iteration`` with JAX's draws injected.

Tolerances, float32: artifacts bit for bit (keys, arrays, header, and the
file's bytes); the demo U-Net's noise prediction within 1e-4 of its
largest magnitude; mode latents within 3e-5 of theirs (and within 1e-5
of the same network in float64, from which XLA's CPU convolutions stray
by 2.2e-5); the VAE(white) background within 1e-5; the joint losses within 1e-4 relative (the U-Net
and the VAE sum their convolutions in other orders)."""

import dataclasses
import json
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import train as jcli
from stable_nerf_tpu.data.dataset import StableNeRFDataset as JDataset
from stable_nerf_tpu.models.diffusion import DDIMScheduler as JDDIMScheduler
from stable_nerf_tpu.models.diffusion import sd_network as jsd
from stable_nerf_tpu.models.diffusion import unet as junet
from stable_nerf_tpu.models.diffusion import vae as jvae
from stable_nerf_tpu.config import HashGridConfig as JHashGridConfig
from stable_nerf_tpu.config import NeRFConfig as JNeRFConfig
from stable_nerf_tpu.config import SDConfig as JSDConfig
from stable_nerf_tpu.config import TrainConfig as JTrainConfig
from stable_nerf_tpu.models.nerf import grid_init as jgrid_init
from stable_nerf_tpu.models.nerf import nerf_init as jnerf_init
from stable_nerf_tpu.training import joint as jj
from stable_nerf_tpu_torch import convert
from stable_nerf_tpu_torch import train as tcli
from stable_nerf_tpu_torch.data.dataset import StableNeRFDataset as TDataset
from stable_nerf_tpu_torch.models.diffusion import sd_network as tsd
from stable_nerf_tpu_torch.models.diffusion import unet as tunet
from stable_nerf_tpu_torch.models.diffusion import vae as tvae
from stable_nerf_tpu_torch.models.diffusion.scheduler import DDIMScheduler
from stable_nerf_tpu_torch.models.nerf.grid import OccupancyGridState
from stable_nerf_tpu_torch.models.nerf.network import nerf_init
from stable_nerf_tpu_torch.training import joint as tj
from stable_nerf_tpu_torch.utils.tree import tree_leaves_with_path, tree_map

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(REPO, "runs", "demo_vae", "vae.npz")
DEMO = ["--dataset", "synthetic", "--demo", "--vae-checkpoint", ARTIFACT]
T = torch.from_numpy


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(float(np.abs(want).max()), 1e-30))


@pytest.fixture(scope="module")
def artifact():
    """The committed artifact in both packages (params on the CPU): the
    port's load, and the same arrays in JAX's layout (JAX's own load, which
    builds an eager template, is held to the port's in the round trip)."""
    params, cfg, meta = tvae.vae_load_npz(ARTIFACT, device="cpu")
    jcfg = jvae.VAEConfig(**dataclasses.asdict(cfg))
    return {"jax": (jax.tree.map(jnp.asarray, convert.params_to_jax(params)), jcfg, meta),
            "port": (params, cfg, meta)}


# --- the demo U-Net -------------------------------------------------------

def test_demo_unet_config_equals_jax():
    for n in (16, 4):
        assert convert.config_from_jax(junet.demo_unet_config(n)) == tunet.demo_unet_config(n)
    cfg = tunet.demo_unet_config()
    assert (cfg.block_out_channels, cfg.transformer_layers, cfg.head_dim,
            cfg.cross_attention_dim, cfg.norm_groups, cfg.ip_num_tokens) == (
        (64, 128), (1, 2), 8, 64, 16, 16)


def _demo_sd_cfg(jvae_cfg):
    return jsd.SDNetworkConfig(
        sd=JSDConfig(latent_size=16, image_size=64, cross_attention_dim=64,
                     num_tokens=16, use_downsampling_layers=False),
        unet=junet.demo_unet_config(16), vae=jvae_cfg)


def test_sd_forward_at_the_demo_config_equals_jax(rng, artifact):
    jcfg = _demo_sd_cfg(artifact["jax"][1])
    tcfg = convert.config_from_jax(jcfg)
    tp = tsd.init_ip_from_unet(tsd.sd_network_init(2, tcfg, device="cpu"))
    jp = jax.tree.map(jnp.asarray, convert.params_to_jax(tp))
    lat = rng.standard_normal((2, 4, 16, 16)).astype(np.float32)
    embeds = rng.standard_normal((4, tcfg.sd.cond_channels, 16, 16)).astype(np.float32)
    t = np.asarray([3, 777])
    want = jax.jit(jsd.sd_forward, static_argnums=4)(
        jp, jnp.asarray(lat), jnp.asarray(t), jnp.asarray(embeds), jcfg)
    got = tsd.sd_forward(tp, T(lat), T(t), T(embeds), tcfg)
    assert got.shape == (2, 4, 16, 16)
    _close(got, want, 1e-4)
    # 16 tokens a view, two views: 32 conditioning tokens of width 64
    assert tsd.embed_conditions(tp, T(embeds), tcfg).shape == (2, 32, 64)


# --- the artifact ----------------------------------------------------------

def test_artifact_written_by_the_port_loads_in_jax_and_back(tmp_path):
    cfg = tvae.VAEConfig(block_out_channels=(16, 32), layers_per_block=1, norm_groups=8,
                         scaling_factor=1.7)
    params = tvae.vae_init(torch.Generator().manual_seed(5), cfg)
    meta = {"recon_psnr_test": 30.5, "image_size": 32, "latent_size": 16}
    a, b = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    tvae.vae_save_npz(a, params, cfg, meta=meta)
    jp, jcfg, jmeta = jvae.vae_load_npz(a)
    assert convert.config_from_jax(jcfg) == cfg and jmeta == meta
    want = dict(tree_leaves_with_path(params))
    got = dict((jax.tree_util.keystr(k), v)
               for k, v in jax.tree_util.tree_flatten_with_path(jp)[0])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k].numpy(), err_msg=k)
    # and what JAX writes of it loads in the port, the file byte for byte
    jvae.vae_save_npz(b, jp, jcfg, meta=jmeta)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    tp, tcfg, tmeta = tvae.vae_load_npz(b, device="cpu")
    assert tcfg == cfg and tmeta == meta and isinstance(tcfg.block_out_channels, tuple)
    for k, v in tree_leaves_with_path(tp):
        assert torch.equal(v, want[k]), k


def test_committed_artifact_rewritten_by_the_port_is_the_same_file(tmp_path, artifact):
    params, cfg, meta = artifact["port"]
    out = str(tmp_path / "again.npz")
    tvae.vae_save_npz(out, params, cfg, meta=meta)
    a, b = np.load(ARTIFACT), np.load(out)
    assert list(a.keys()) == list(b.keys())           # JAX's leaf order
    assert len(a.keys()) == 157                        # 156 leaves and the header
    for k in a.keys():
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    header = json.loads(bytes(a["__vae_meta__"].tobytes()).decode())
    assert header["config"]["block_out_channels"] == [32, 64, 128]
    with open(ARTIFACT, "rb") as fa, open(out, "rb") as fb:
        assert fa.read() == fb.read()


def test_a_leaf_of_the_wrong_shape_is_refused_alike(tmp_path):
    """A small artifact with one leaf cut short: both loaders raise the
    same message; with the leaf missing, the port raises KeyError."""
    cfg = tvae.VAEConfig(block_out_channels=(16, 32), layers_per_block=1, norm_groups=8)
    good = str(tmp_path / "good.npz")
    tvae.vae_save_npz(good, tvae.vae_init(torch.Generator().manual_seed(6), cfg), cfg)
    a = np.load(good)
    arrays = {k: a[k] for k in a.keys()}
    key = "['encoder']['conv_in']['kernel']"
    arrays[key] = arrays[key][:8]
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, **arrays)
    with pytest.raises(ValueError) as je:
        jvae.vae_load_npz(bad)
    with pytest.raises(ValueError) as te:
        tvae.vae_load_npz(bad, device="cpu")
    assert str(te.value) == str(je.value)
    assert "config expects (16, 3, 3, 3)" in str(te.value)
    del arrays[key]
    np.savez(bad, **arrays)
    with pytest.raises(KeyError):
        tvae.vae_load_npz(bad, device="cpu")


def test_committed_artifact_mode_latents_and_background_equal_jax(artifact):
    jp, jcfg, jmeta = artifact["jax"]
    tp, tcfg, tmeta = artifact["port"]
    assert convert.config_from_jax(jcfg) == tcfg and tmeta == jmeta
    assert tcfg.scaling_factor == pytest.approx(2.2977119523651015, rel=1e-15)
    ds = TDataset("synthetic", shape=64, encoded_shape=16, root=os.path.join(REPO, "datasets"),
                  scale_intrinsics=True)
    x = ds.reference_images[[0, 9, 21, 40]]
    sd_cfg = _demo_sd_cfg(jcfg)
    want = jax.jit(lambda p, im: jsd.encode_images_mode({"vae": p}, im, sd_cfg))(
        jp, jnp.asarray(x))
    got = tsd.encode_images_mode({"vae": tp}, T(x), convert.config_from_jax(sd_cfg))
    assert got.shape == (4, 4, 16, 16)
    # the same network in float64: the port's float32 lies within 1e-6 of
    # it, XLA's CPU float32 within 2.3e-5 (measured), hence 3e-5 between them
    exact = tvae.vae_encode_mode(tree_map(lambda a: a.double(), tp), T(x).double(), tcfg)
    _close(got, exact.numpy(), 1e-5)
    _close(got, want, 3e-5)
    # the CLI's per-channel latent background: (mean mode latent of white + 1) / 2
    white = jnp.ones((1, 3, 64, 64))
    lt = jsd.encode_images_mode({"vae": jp}, white, sd_cfg)
    jbg = (np.asarray(lt).mean(axis=(0, 2, 3)) + 1.0) / 2.0
    args = tcli.build_parser().parse_args(DEMO)
    tcli.apply_demo_defaults(args)
    tbg = tcli.latent_background(tp, tcli.build_config(args, tcfg), torch.device("cpu"))
    np.testing.assert_allclose(tbg, jbg, rtol=0, atol=1e-5)
    # chip_smoke.py holds the card's value to these numbers
    np.testing.assert_allclose(chip_smoke.DEMO_BG_F32, jbg, rtol=0, atol=1e-6)


# --- the CLI ---------------------------------------------------------------

class _Loaded(Exception):
    pass


def _jax_main(argv):
    """train.py's JointConfig and dataset arguments for ``argv`` and what
    it prints, stopped where it loads the data."""
    seen, real = {}, jj.JointConfig

    def joint_config(**kw):
        seen["cfg"] = real(**kw)
        return seen["cfg"]

    def dataset(*a, **kw):
        seen["dataset"] = kw
        raise _Loaded

    with mock.patch("stable_nerf_tpu.training.joint.JointConfig", joint_config), \
            mock.patch("stable_nerf_tpu.data.dataset.StableNeRFDataset", dataset):
        with pytest.raises(_Loaded):
            jcli.main(argv + ["--workdir", "unused", "--compile-cache", "none"])
    return seen


def _port_main(argv):
    seen, build = {}, tcli.build_config

    def build_config(*a, **kw):
        seen["cfg"] = build(*a, **kw)
        return seen["cfg"]

    def dataset(*a, **kw):
        seen["dataset"] = kw
        raise _Loaded

    with mock.patch.object(tcli, "build_config", build_config), \
            mock.patch("stable_nerf_tpu_torch.data.dataset.StableNeRFDataset", dataset):
        with pytest.raises(_Loaded):
            tcli.main(argv + ["--workdir", "unused", "--device", "cpu"])
    return seen


def _lines(out, prefix):
    return [line for line in out.splitlines() if line.startswith(prefix)]


@pytest.mark.parametrize("extra", [[], ["--image-size", "64", "--latent-size", "16",
                                        "--trainable-scope", "reference",
                                        "--vae-encode", "sample", "--batch-size", "8",
                                        "--nerf-lr", "0.01", "--lr", "0.001"]])
def test_cli_demo_configuration_equals_jax(capsys, extra):
    want = _jax_main(DEMO + extra)
    jout = capsys.readouterr().out
    got = _port_main(DEMO + extra)
    tout = capsys.readouterr().out
    assert convert.config_from_jax(want["cfg"].nerf) == got["cfg"].nerf
    assert convert.config_from_jax(want["cfg"].sd) == got["cfg"].sd
    assert convert.config_from_jax(want["cfg"].train) == got["cfg"].train
    assert got["cfg"].nerf.density_activation == "trunc_exp"
    assert got["cfg"].sd.vae.scaling_factor == pytest.approx(2.2977119523651015)
    for k in ("shape", "encoded_shape", "scale_intrinsics", "seed"):
        assert got["dataset"][k] == want["dataset"][k], k
    assert got["dataset"]["scale_intrinsics"] is True
    for prefix in ("VAE checkpoint:", "latent background from VAE(white):"):
        assert _lines(tout, prefix) == _lines(jout, prefix), prefix
    assert _lines(tout, "latent background") == [
        "latent background from VAE(white): [0.5, 0.722, 0.421, 0.564]"]


def test_cli_demo_without_an_artifact_derives_the_vae_as_jax():
    for sizes in ([], ["--image-size", "128", "--latent-size", "16"]):
        argv = ["--dataset", "synthetic", "--demo"] + sizes
        want, got = _jax_main(argv), _port_main(argv)
        assert convert.config_from_jax(want["cfg"].sd) == got["cfg"].sd
        assert convert.config_from_jax(want["cfg"].train) == got["cfg"].train
        assert got["cfg"].train.bg_color == 1.0


@pytest.mark.parametrize("argv", [
    ["--dataset", "synthetic", "--tiny", "--demo"],
    ["--dataset", "synthetic", "--vae-checkpoint", ARTIFACT],
    DEMO + ["--latent-size", "8"],
    DEMO + ["--image-size", "128"],
    ["--dataset", "synthetic", "--demo", "--image-size", "48"],
])
def test_cli_refuses_as_jax_refuses(argv):
    with pytest.raises(SystemExit) as je:
        jcli.main(argv + ["--workdir", "unused", "--compile-cache", "none"])
    with pytest.raises(SystemExit) as te:
        tcli.main(argv + ["--workdir", "unused", "--device", "cpu"])
    assert isinstance(te.value.code, str) and te.value.code == je.value.code


# --- one demo step ---------------------------------------------------------

def test_demo_forward_iteration_equals_jax(artifact):
    """The demo's joint forward pass (mode encode, per-channel background,
    geometric intrinsics, 16 tokens a view) on a small NeRF, batch 2 of the
    synthetic scene at 64² / 16², JAX's draws injected."""
    jvp, jvae_cfg, _ = artifact["jax"]
    jcfg = jj.JointConfig(
        nerf=JNeRFConfig(channel_dim=4, density_activation="trunc_exp", grid_size=32,
                           encoding_sigma=JHashGridConfig(n_levels=4, log2_hashmap_size=12,
                                                          base_resolution=4)),
        sd=_demo_sd_cfg(jvae_cfg),
        train=JTrainConfig(max_steps_train=32, vae_encode="mode", trainable_scope="sd",
                             bg_color=(0.4997452, 0.7217328, 0.42126554, 0.56418204)))
    tcfg = convert.config_from_jax(jcfg)
    tp = {"sd": tsd.init_ip_from_unet(tsd.sd_network_init(4, tcfg.sd, device="cpu")),
          "nerf": nerf_init(5, tcfg.nerf, device="cpu")}
    tp["sd"]["vae"] = artifact["port"][0]
    like = jax.eval_shape(lambda: {"sd": jsd.sd_network_init(jax.random.PRNGKey(0), jcfg.sd),
                                   "nerf": jnerf_init(jax.random.PRNGKey(1), jcfg.nerf)})
    jp = jax.tree.map(jnp.asarray, convert.params_to_jax(tp, like=like))
    ds = JDataset("synthetic", shape=64, encoded_shape=16,
                  root=os.path.join(REPO, "datasets"), scale_intrinsics=True)
    batch = {k: np.stack([ds[i][k] for i in (3, 17)]) for k in ds[0]}
    grid = jgrid_init(jcfg.nerf)
    grid = grid._replace(occ=jnp.ones_like(grid.occ))
    sched = JDDIMScheduler.create(jcfg.sd.scheduler)
    key = jax.random.PRNGKey(8)
    k_vae, k_noise, k_t, k_perturb = jax.random.split(key, 4)
    draws = {"vae_eps": jax.random.normal(k_vae, (4, 4, 16, 16)),
             "noise": jax.random.normal(k_noise, (2, 4, 16, 16)),
             "timesteps": jax.random.randint(k_t, (2,), 0, 1000),
             "perturb": jax.random.uniform(k_perturb, (4 * 256,))}
    js, jn, jaux = jax.jit(lambda p, b: jj.forward_iteration(
        p, grid, b, key, jcfg, sched, compute_dtype=jnp.float32))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    s, n, aux = tj.forward_iteration(
        tp, OccupancyGridState(*(T(np.array(a)) for a in grid)),
        {k: T(np.ascontiguousarray(v)) for k, v in batch.items()}, tcfg,
        DDIMScheduler.create(tcfg.sd.scheduler, device="cpu"), compute_dtype=torch.float32,
        draws={k: T(np.array(v)) for k, v in draws.items()})
    np.testing.assert_allclose([float(s), float(n)], [float(js), float(jn)], rtol=1e-4)
    _close(aux["noise_pred"], jaux["noise_pred"], 1e-4)
    assert tcfg.train.bg_color == jcfg.train.bg_color


def test_trainable_only_restore_refuses_another_vae(artifact):
    """A trainable-only checkpoint of the demo records no fingerprint of
    its VAE overlay (JAX's train.py passes none either); the frozen
    checksum of the rebuilt partition refuses a rebuild on another VAE: the
    seed's random one, or the artifact scaled by 1%."""
    from stable_nerf_tpu_torch.config import HashGridConfig
    from stable_nerf_tpu_torch.training.checkpoints import (frozen_partition_checksum,
                                                            verify_frozen_checksum)
    from stable_nerf_tpu_torch.training.loop import build_initial_params

    args = tcli.build_parser().parse_args(DEMO)
    tcli.apply_demo_defaults(args)
    vp, vcfg, _ = artifact["port"]
    cfg = tcli.build_config(args, vcfg)
    cfg = dataclasses.replace(cfg, nerf=dataclasses.replace(
        cfg.nerf, encoding_sigma=HashGridConfig(n_levels=4, log2_hashmap_size=12)))

    def checksum(overlay):
        params = build_initial_params(cfg, 0, 1, None if overlay is None else {"vae": overlay},
                                      device="cpu", log_fn=lambda m: None)
        return frozen_partition_checksum(params, tj.joint_trainable_mask(
            params, cfg.train.trainable_scope))

    recorded = checksum(vp)
    # scope "sd": the VAE and the cached text conditioning are frozen
    assert set(recorded) == {"vae", "add_text_embeds", "add_time_ids"}
    verify_frozen_checksum(recorded, checksum(vp), log_fn=lambda m: None)
    for other in (None, tree_map(lambda x: x * 1.01, vp)):
        with pytest.raises(ValueError, match="checksum mismatch"):
            verify_frozen_checksum(recorded, checksum(other))
