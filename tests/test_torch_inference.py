"""The port's serving path (training/inference.py::make_inference_step and
training/joint.py::make_eval_step) against the JAX package's on the CPU, at
the dry-run scale of ``__graft_entry__._tiny_joint_setup`` with a sparse
occupancy grid and a binding eval budget (8 samples a ray of 64 march
steps), so the compaction branch sees a real mask.

Same weights (port init → JAX layout and back), same batch, and JAX's own
random draws injected: ``k_vae, k_init = jax.random.split(key)``
(inference.py:81), the encode's ``normal(k_vae, ...)`` (vae.py:242) and the
initial latents ``normal(k_init, ...)`` (inference.py:117).

Tolerances, float32 compute: every result key within ``1e-4 · steps`` of
the key's largest reference entry.  Each DDIM step runs the tiny U-Net, whose
float32 sums the two frameworks take in other orders (1e-4 in
tests/test_torch_diffusion.py), and feeds its output to the next step, so
the bound grows with the number of steps.  SSIM is a mean over values in
[-1, 1] that is near 0 for unrelated images, so it is held to the same
bound absolutely (scale 1).  The eval step's losses within
1e-5 relative in float32 and 3e-2 in bf16, as the train step's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from stable_nerf_tpu.config import HashGridConfig as JHashGridConfig
from stable_nerf_tpu.config import NeRFConfig as JNeRFConfig
from stable_nerf_tpu.config import SDConfig as JSDConfig
from stable_nerf_tpu.config import TrainConfig as JTrainConfig
from stable_nerf_tpu.models.diffusion import DDIMScheduler as JDDIMScheduler
from stable_nerf_tpu.models.diffusion import sd_network as jsd
from stable_nerf_tpu.models.diffusion.unet import tiny_unet_config
from stable_nerf_tpu.models.diffusion.vae import VAEConfig as JVAEConfig
from stable_nerf_tpu.models.nerf import grid_init as jgrid_init
from stable_nerf_tpu.models.nerf import nerf_init as jnerf_init
from stable_nerf_tpu.training import inference as jinf
from stable_nerf_tpu.training import joint as jj
from stable_nerf_tpu_torch import convert
from stable_nerf_tpu_torch.models.diffusion.scheduler import DDIMScheduler
from stable_nerf_tpu_torch.models.diffusion.sd_network import (init_ip_from_unet,
                                                               sd_network_init)
from stable_nerf_tpu_torch.models.nerf.grid import OccupancyGridState
from stable_nerf_tpu_torch.models.nerf.network import nerf_init
from stable_nerf_tpu_torch.training import inference as tinf
from stable_nerf_tpu_torch.training import joint as tj

torch.set_num_threads(2)
B = 2


def _tiny_joint_config(**train):
    return jj.JointConfig(
        nerf=JNeRFConfig(channel_dim=4, grid_size=32,
                         encoding_sigma=JHashGridConfig(n_levels=4, log2_hashmap_size=12,
                                                        base_resolution=4)),
        sd=jsd.SDNetworkConfig(
            sd=JSDConfig(num_tokens=2, use_downsampling_layers=True,
                         cross_attention_dim=48, latent_size=16, image_size=32),
            unet=tiny_unet_config(),
            vae=JVAEConfig(block_out_channels=(16, 32), layers_per_block=1,
                           norm_groups=8)),
        train=JTrainConfig(max_steps_train=32, max_steps_eval=64,
                           sample_budget_eval_per_ray=8, **train))


@pytest.fixture(scope="module")
def ref(request):
    """Weights, a sparse grid and a batch in both packages' layouts."""
    jcfg = _tiny_joint_config()
    tcfg = convert.config_from_jax(jcfg)
    seed_tree = {"sd": init_ip_from_unet(sd_network_init(0, tcfg.sd, device="cpu")),
                 "nerf": nerf_init(1, tcfg.nerf, device="cpu")}
    # a table wide enough (±1) for the render to differ from the background
    seed_tree["nerf"]["hash"]["table"].mul_(1e4)
    like = jax.eval_shape(lambda: {
        "sd": jsd.sd_network_init(jax.random.PRNGKey(0), jcfg.sd),
        "nerf": jnerf_init(jax.random.PRNGKey(1), jcfg.nerf)})
    jparams = jax.tree.map(jnp.asarray, convert.params_to_jax(seed_tree, like=like))
    rng = np.random.default_rng(11)
    grid = jgrid_init(jcfg.nerf)
    grid = grid._replace(occ=jnp.asarray(rng.random(grid.occ.shape) < 0.4))
    batch = ge._make_batch(jcfg, B, jax.random.PRNGKey(1))
    return {
        "jparams": jparams, "jgrid": grid, "jbatch": batch,
        "params": convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                          like=seed_tree),
        "grid": OccupancyGridState(*(torch.from_numpy(np.array(a)) for a in grid)),
        "batch": {k: torch.from_numpy(np.array(v)) for k, v in batch.items()},
    }


def _close_to_scale(got, want, rtol, name):
    want = np.asarray(want, np.float32)
    scale = 1.0 if name == "ssim" else max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rtol * scale, err_msg=name)


def test_grid_with_sparse_occ_round_trips(ref):
    """OccupancyGridState through numpy both ways keeps a mask that is
    neither empty nor full, bit for bit."""
    occ = ref["grid"].occ
    assert occ.dtype == torch.bool and 0.3 < float(occ.float().mean()) < 0.5
    back = type(ref["jgrid"])(*(jnp.asarray(t.numpy()) for t in ref["grid"]))
    for a, b in zip(back, ref["jgrid"]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("steps,guidance,vae_encode,capture", [
    (2, 1.0, "sample", False),
    (5, 3.0, "mode", True),
    (2, 1.0, "mode", True),
    (5, 1.0, "sample", False),
])
def test_inference_step_matches_jax(ref, steps, guidance, vae_encode, capture):
    jcfg = _tiny_joint_config(vae_encode=vae_encode)
    tcfg = convert.config_from_jax(jcfg)
    key = jax.random.PRNGKey(9)
    jstep = jax.jit(jinf.make_inference_step(
        jcfg, JDDIMScheduler.create(jcfg.sd.scheduler), steps,
        compute_dtype=jnp.float32, guidance_scale=guidance, capture_attn_maps=capture))
    want = jstep(ref["jparams"], ref["jgrid"], ref["jbatch"], key)

    k_vae, k_init = jax.random.split(key)
    enc = jcfg.latent_hw
    draws = {"vae_eps": jax.random.normal(k_vae, (B, 4, enc, enc), jnp.float32),
             "init_latents": jax.random.normal(k_init, (B, 4, enc, enc))}
    draws = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
    step = tinf.make_inference_step(
        tcfg, DDIMScheduler.create(tcfg.sd.scheduler, device="cpu"), steps,
        compute_dtype=torch.float32, guidance_scale=guidance,
        capture_attn_maps=capture, device="cpu")
    got = step(ref["params"], ref["grid"], ref["batch"], draws=draws)

    assert set(got) == set(want)
    assert ("ip_attn_maps" in got) == capture
    rtol = 1e-4 * steps
    for k, w in want.items():
        if k == "ip_attn_maps":
            assert len(got[k]) == len(w) == 6
            for i, (m, wm) in enumerate(zip(got[k], w)):
                assert tuple(m.shape) == wm.shape and m.shape[0] == B
                _close_to_scale(m.numpy(), wm, rtol, f"{k}[{i}]")
        else:
            assert tuple(got[k].shape) == w.shape, k
            _close_to_scale(got[k].numpy(), w, rtol, k)
    d = got["denoised_image"]
    assert d.shape == (B, 3, 32, 32) and float(d.min()) >= 0 and float(d.max()) <= 1
    # the budget binds and the grid is sparse: the render is neither the
    # background (1.0) nor saturated
    lt = got["pred_target_latent"]
    assert 0.05 < float((lt < 0.999).float().mean()) < 1.0


def test_inference_draws_from_generator_and_refuses_without(ref):
    tcfg = convert.config_from_jax(_tiny_joint_config())
    step = tinf.make_inference_step(
        tcfg, DDIMScheduler.create(tcfg.sd.scheduler, device="cpu"), 2,
        compute_dtype=torch.float32, device="cpu")
    outs = [step(ref["params"], ref["grid"], ref["batch"],
                 generator=torch.Generator().manual_seed(3)) for _ in range(2)]
    assert torch.equal(outs[0]["denoised_image"], outs[1]["denoised_image"])
    assert bool(outs[0]["psnr"].isfinite().all()) and outs[0]["psnr"].shape == (B, 1)
    with pytest.raises(ValueError, match="no generator"):
        step(ref["params"], ref["grid"], ref["batch"])
    stages = []
    hooked = tinf.make_inference_step(
        tcfg, DDIMScheduler.create(tcfg.sd.scheduler, device="cpu"), 1,
        compute_dtype=torch.float32, device="cpu", stage_hook=stages.append)
    hooked(ref["params"], ref["grid"], ref["batch"],
           generator=torch.Generator().manual_seed(3))
    assert stages == ["encode", "render", "denoise", "decode"]


@pytest.mark.parametrize("dtype,budget", [("float32", None), ("float32", 1500),
                                          ("bfloat16", None)])
def test_eval_step_matches_jax(ref, dtype, budget):
    """``make_eval_step`` (no grad, eval march, budgeted render of target
    and reference rays) against JAX's ``forward_iteration(train=False)``
    with the draws it makes from its key."""
    jcfg = _tiny_joint_config()
    tcfg = convert.config_from_jax(jcfg)
    key = jax.random.PRNGKey(5)
    jsched = JDDIMScheduler.create(jcfg.sd.scheduler)
    js, jn, _ = jax.jit(lambda p: jj.forward_iteration(
        p, ref["jgrid"], ref["jbatch"], key, jcfg, jsched, train=False,
        compute_dtype=getattr(jnp, dtype), sample_budget=budget))(ref["jparams"])
    enc = jcfg.latent_hw
    k_vae, k_noise, k_t, _ = jax.random.split(key, 4)
    draws = {"vae_eps": jax.random.normal(k_vae, (2 * B, 4, enc, enc)),
             "noise": jax.random.normal(k_noise, (B, 4, enc, enc)),
             "timesteps": jax.random.randint(k_t, (B,), 0, 1000)}
    draws = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
    step = tj.make_eval_step(tcfg, DDIMScheduler.create(tcfg.sd.scheduler, device="cpu"),
                             budget, compute_dtype=getattr(torch, dtype), device="cpu")
    table = ref["params"]["nerf"]["hash"]["table"].requires_grad_(True)
    try:
        m = step(ref["params"], ref["grid"], ref["batch"], draws=draws)
    finally:
        table.requires_grad_(False)
    assert not m["loss"].requires_grad                 # no grad, whatever the leaves say
    rtol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose([float(m["sd_loss"]), float(m["nerf_loss"])],
                               [float(js), float(jn)], rtol=rtol)
    np.testing.assert_allclose(float(m["loss"]), float(js) + float(jn), rtol=rtol)
    with pytest.raises(ValueError, match="step built for"):
        tj.make_eval_step(tcfg, None, device="meta")(ref["params"], ref["grid"],
                                                     ref["batch"], draws=draws)


def test_new_train_config_fields_convert():
    jcfg = _tiny_joint_config(num_inference_steps=7, sample_budget_eval_auto=False)
    t = convert.config_from_jax(jcfg).train
    assert (t.num_inference_steps, t.sample_budget_eval_auto,
            t.sample_budget_eval_per_ray) == (7, False, 8)
    with pytest.raises(TypeError, match="is not ported"):
        convert.config_from_jax(dataclasses.replace(jcfg.train, mixed_precision="float32"))
