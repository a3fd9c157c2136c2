"""The port's diffusion stack (nn primitives, DDIM scheduler, VAE encoder
and decoder, IP-Adapter, U-Net, SDNetwork, image metrics) against the JAX package's on the CPU, same
converted weights.  float32 within 1e-5 relative for the primitives and
1e-4 for the tiny U-Net and VAE (deep stacks of f32 sums in other orders);
the scheduler against the repo's float64 golden fixture at the JAX tests'
own tolerances.  The image metrics (full-f32 sums and 11-tap
convolutions) within 1e-5."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_nerf_tpu.config import SchedulerConfig as JSchedulerConfig
from stable_nerf_tpu.config import SDConfig as JSDConfig
from stable_nerf_tpu.models.diffusion import nn as jnn
from stable_nerf_tpu.models.diffusion import sd_network as jsd
from stable_nerf_tpu.models.diffusion import unet as junet
from stable_nerf_tpu.models.diffusion import vae as jvae
from stable_nerf_tpu.models.diffusion.scheduler import DDIMScheduler as JDDIMScheduler
from stable_nerf_tpu.utils import losses as jlosses
from stable_nerf_tpu_torch import convert
from stable_nerf_tpu_torch.config import SchedulerConfig
from stable_nerf_tpu_torch.models.diffusion import nn as tnn
from stable_nerf_tpu_torch.models.diffusion import sd_network as tsd
from stable_nerf_tpu_torch.models.diffusion import unet as tunet
from stable_nerf_tpu_torch.models.diffusion import vae as tvae
from stable_nerf_tpu_torch.models.diffusion.scheduler import DDIMScheduler
from stable_nerf_tpu_torch.utils import losses as tlosses
from stable_nerf_tpu_torch.utils.tree import tree_leaves, tree_map

torch.set_num_threads(2)
T = torch.from_numpy


def _close(a, b, rtol, scale_atol=True):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    atol = rtol * max(float(np.abs(b).max()), 1e-6) if scale_atol else 0
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


# -- primitives ------------------------------------------------------------

@pytest.mark.parametrize("stride,padding,k", [(1, 1, 3), (2, 1, 4), (4, 0, 4), (1, 0, 1)])
def test_conv2d_and_linear(rng, stride, padding, k):
    x = rng.standard_normal((2, 5, 16, 16)).astype(np.float32)
    p = {"kernel": rng.standard_normal((6, 5, k, k)).astype(np.float32),
         "bias": rng.standard_normal(6).astype(np.float32)}
    _close(tnn.conv2d({k_: T(v) for k_, v in p.items()}, T(x), stride, padding),
           jnn.conv2d(p, jnp.asarray(x), stride, padding), 1e-5)
    lp = {"kernel": rng.standard_normal((5, 7)).astype(np.float32),
          "bias": rng.standard_normal(7).astype(np.float32)}
    y = rng.standard_normal((3, 4, 5)).astype(np.float32)
    _close(tnn.linear({k_: T(v) for k_, v in lp.items()}, T(y)),
           jnn.linear(lp, jnp.asarray(y)), 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_keep_f32_statistics(rng, dtype):
    x = (rng.standard_normal((2, 16, 6, 6)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.standard_normal(16).astype(np.float32),
         "bias": rng.standard_normal(16).astype(np.float32)}
    tp = {k: T(v) for k, v in p.items()}
    tol = 1e-5 if dtype == "float32" else 1e-2
    tx, jx = T(x).to(getattr(torch, dtype)), jnp.asarray(x).astype(getattr(jnp, dtype))
    out = tnn.group_norm(tp, tx, 4)
    assert out.dtype == tx.dtype
    _close(out.float(), jnn.group_norm(p, jx, 4).astype(jnp.float32), tol)
    y = tx.reshape(2, 16, 36).transpose(1, 2)
    _close(tnn.layer_norm(tp, y).float(),
           jnn.layer_norm(p, jx.reshape(2, 16, 36).transpose(0, 2, 1)).astype(jnp.float32),
           tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sdpa_heads_and_f32_logits(rng, dtype):
    q, k, v = (rng.standard_normal((2, 24, 32)).astype(np.float32) for _ in range(3))
    tq, tk, tv = (tnn.split_heads(T(a).to(getattr(torch, dtype)), 4) for a in (q, k, v))
    jq, jk, jv = (jnn.split_heads(jnp.asarray(a).astype(getattr(jnp, dtype)), 4)
                  for a in (q, k, v))
    out = tnn.merge_heads(tnn.sdpa(tq, tk, tv))
    assert out.dtype == tq.dtype
    tol = 1e-5 if dtype == "float32" else 1e-2
    _close(out.float(), jnn.merge_heads(jnn.sdpa(jq, jk, jv)).astype(jnp.float32), tol)


def test_timestep_embedding(rng):
    t = rng.integers(0, 1000, 5)
    _close(tnn.timestep_embedding(T(t), 32),
           jnn.timestep_embedding(jnp.asarray(t), 32), 1e-5)


# -- scheduler: the float64 golden fixture ---------------------------------

@pytest.fixture(scope="module")
def golden():
    return np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                                "ddim_golden.npz"))


def test_scheduler_matches_golden_fixture(golden):
    s = DDIMScheduler.create(SchedulerConfig(), device="cpu")
    np.testing.assert_array_equal(s.alphas_cumprod.numpy(),
                                  golden["alphas_cumprod"].astype(np.float32))
    np.testing.assert_array_equal(np.float32(s.final_alpha_cumprod),
                                  golden["final_alpha_cumprod"].astype(np.float32))
    np.testing.assert_array_equal(s.timesteps(50), golden["timesteps_50"])
    for i, t in enumerate(golden["probe_ts"]):
        x_prev, pred_x0 = s.step(T(golden["step_model_outputs"][i].astype(np.float32)),
                                 int(t), T(golden["step_samples"][i].astype(np.float32)),
                                 num_inference_steps=50)
        np.testing.assert_allclose(x_prev.numpy(), golden["step_prev_samples"][i],
                                   rtol=2e-6, atol=2e-6)
        np.testing.assert_allclose(pred_x0.numpy(), golden["step_pred_x0"][i],
                                   rtol=2e-5, atol=2e-5)
    noisy = s.add_noise(T(golden["add_noise_x0"].astype(np.float32)),
                        T(golden["add_noise_noise"].astype(np.float32)),
                        T(golden["probe_ts"]))
    np.testing.assert_allclose(noisy.numpy(), golden["add_noise_noisy"],
                               rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
@pytest.mark.parametrize("n_steps", [1, 10, 50])
def test_scheduler_denoise_equals_jax_loop(n_steps, prediction_type):
    """``DDIMScheduler.denoise`` with a toy noise function against the JAX
    scheduler's ``step`` over its ``timesteps``, eagerly, on the same
    float32 latents.  Tolerance 2e-6 of the largest magnitude: XLA's and
    PyTorch's float32 square roots and divisions may differ by an ulp, and
    that compounds over 50 steps (the worst case measured 6e-7)."""
    x0 = np.random.default_rng(n_steps).standard_normal((2, 4, 8, 8)).astype(np.float32)
    scheduler = DDIMScheduler.create(SchedulerConfig(prediction_type=prediction_type),
                                     device="cpu")
    got = scheduler.denoise(lambda x, t: torch.tanh(x) * (t / 1000.0) + 0.1 * x, T(x0),
                            n_steps)

    jscheduler = JDDIMScheduler.create(JSchedulerConfig(prediction_type=prediction_type))
    x = jnp.asarray(x0)
    for t in jnp.asarray(jscheduler.timesteps(n_steps)):
        x, _ = jscheduler.step(jnp.tanh(x) * (t / 1000.0) + 0.1 * x, t, x,
                               num_inference_steps=n_steps)
    assert got.dtype == torch.float32
    _close(got.numpy(), x, 2e-6)


# -- VAE, U-Net, SDNetwork --------------------------------------------------

TINY_VAE = dict(block_out_channels=(16, 32), layers_per_block=1, norm_groups=8)


def _shapes(tree):
    return [tuple(x.shape) for x in jax.tree.leaves(tree)]


def test_init_trees_match_reference_structure():
    """Same keys, nesting and leaf shapes as the JAX inits: the flagship
    SDXL VAE (abstractly on the JAX side) and the tiny SD network."""
    jtree = jax.eval_shape(lambda: jvae.vae_init(jax.random.PRNGKey(0), jvae.VAEConfig()))
    like = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), jtree)
    g = torch.Generator().manual_seed(0)
    tree = tvae.vae_init(g, tvae.VAEConfig())
    convert.params_from_jax(like, like=tree)      # raises on any mismatch
    assert sum(x.numel() for x in tree_leaves(tree)) == 83_653_863

    jcfg = _tiny_sd_cfg()
    jtree = jax.eval_shape(lambda: jsd.sd_network_init(jax.random.PRNGKey(0), jcfg))
    like = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), jtree)
    convert.params_from_jax(like, like=tsd.sd_network_init(
        0, convert.config_from_jax(jcfg), device="cpu"))


def _tiny_sd_cfg():
    return jsd.SDNetworkConfig(
        sd=JSDConfig(num_tokens=2, use_downsampling_layers=True, cross_attention_dim=48,
                     latent_size=16, image_size=32),
        unet=junet.tiny_unet_config(), vae=jvae.VAEConfig(**TINY_VAE))


@pytest.fixture(scope="module")
def tiny_sd():
    jcfg = _tiny_sd_cfg()
    tcfg = convert.config_from_jax(jcfg)
    tp = tsd.init_ip_from_unet(tsd.sd_network_init(3, tcfg, device="cpu"))
    jp = jax.tree.map(jnp.asarray, convert.params_to_jax(tp))
    return jcfg, tcfg, jp, tp


def test_vae_encode(rng, tiny_sd):
    jcfg, tcfg, jp, tp = tiny_sd
    x = rng.uniform(-1, 1, (2, 3, 32, 32)).astype(np.float32)
    jm, jl = jax.jit(jvae.vae_encode_moments, static_argnums=2)(jp["vae"], jnp.asarray(x),
                                                                 jcfg.vae)
    tm, tl = tvae.vae_encode_moments(tp["vae"], T(x), tcfg.vae)
    _close(tm, jm, 1e-4)
    _close(tl, jl, 1e-4)
    key = jax.random.PRNGKey(5)
    eps = jax.random.normal(key, jm.shape)
    z = tsd.encode_images(tp, T(x), tcfg, eps=T(np.asarray(eps)))
    _close(z, jsd.encode_images(jp, jnp.asarray(x), key, jcfg), 1e-4)
    _close(tsd.encode_images_mode(tp, T(x), tcfg),
           jsd.encode_images_mode(jp, jnp.asarray(x), jcfg), 1e-4)


def test_trainable_mask_and_ip_init(tiny_sd):
    jcfg, tcfg, jp, tp = tiny_sd
    # a tree of Python bools is a pytree: compare in JAX's (sorted) order
    assert jax.tree.leaves(tsd.trainable_mask(tp)) == jax.tree.leaves(
        jsd.trainable_mask(jp))
    attn = tp["unet"]["mid_block"]["attentions"][0]["blocks"][0]["attn2"]
    assert torch.equal(attn["to_k_ip"]["kernel"], attn["to_k"]["kernel"])
    assert attn["to_k_ip"]["kernel"].data_ptr() != attn["to_k"]["kernel"].data_ptr()


def test_sd_forward_two_stream_ip_attention(rng, tiny_sd):
    """Noise prediction through the conditioning CNN, ImageProjModel and the
    U-Net whose cross-attention splits the 4 tokens by position."""
    jcfg, tcfg, _, tp = tiny_sd
    # distinct ip heads, so the text and ip streams differ (on a copy: the
    # fixture is shared by the module's tests)
    tp = tree_map(torch.clone, tp)
    for blk in tp["unet"]["mid_block"]["attentions"][0]["blocks"]:
        blk["attn2"]["to_v_ip"]["kernel"].mul_(-2.0)
    jp = jax.tree.map(jnp.asarray, convert.params_to_jax(tp))
    lat = rng.standard_normal((2, 4, 16, 16)).astype(np.float32)
    embeds = rng.standard_normal((4, 7, 16, 16)).astype(np.float32)
    t = np.asarray([10, 900])
    want = jax.jit(jsd.sd_forward, static_argnums=4)(
        jp, jnp.asarray(lat), jnp.asarray(t), jnp.asarray(embeds), jcfg)
    got = tsd.sd_forward(tp, T(lat), T(t), T(embeds), tcfg)
    _close(got, want, 1e-4)
    tokens = tsd.embed_conditions(tp, T(embeds), tcfg)
    assert tokens.shape == (2, 4, 48)
    _close(tokens, jsd.embed_conditions(jp, jnp.asarray(embeds), jcfg), 1e-5)


def test_unet_bf16_compute_close_to_reference(rng, tiny_sd):
    jcfg, tcfg, jp, tp = tiny_sd
    lat = rng.standard_normal((1, 4, 16, 16)).astype(np.float32)
    ctx = rng.standard_normal((1, 4, 48)).astype(np.float32)
    kw = dict(added_text_embeds=np.zeros((1, 32), np.float32),
              added_time_ids=np.full((1, 6), 32.0, np.float32))
    want = jax.jit(lambda p: junet.unet_apply(
        p, jnp.asarray(lat), jnp.asarray([500]), jnp.asarray(ctx), cfg=jcfg.unet,
        compute_dtype=jnp.bfloat16, **{k: jnp.asarray(v) for k, v in kw.items()}))(
        jp["unet"])
    got = tunet.unet_apply(tp["unet"], T(lat), T(np.asarray([500])), T(ctx),
                           cfg=tcfg.unet, compute_dtype=torch.bfloat16,
                           **{k: T(v) for k, v in kw.items()})
    assert got.dtype == torch.float32
    # bf16 rounds at other places in the two frameworks: hold the output
    # to 3% of its scale
    _close(got, want, 3e-2)


def test_vae_decode_and_decode_latents(rng, tiny_sd):
    """The decoder (post_quant_conv, mid block, up blocks with nearest x2
    upsampling) on scaled latents, and encode → decode end to end."""
    jcfg, tcfg, jp, tp = tiny_sd
    z = rng.standard_normal((2, 4, 16, 16)).astype(np.float32)
    want = jax.jit(jvae.vae_decode, static_argnums=2)(jp["vae"], jnp.asarray(z), jcfg.vae)
    got = tvae.vae_decode(tp["vae"], T(z), tcfg.vae)
    assert got.shape == (2, 3, 32, 32)      # two levels: one x2 upsample
    _close(got, want, 1e-4)
    _close(tsd.decode_latents(tp, T(z), tcfg),
           jax.jit(jsd.decode_latents, static_argnums=2)(jp, jnp.asarray(z), jcfg), 1e-4)


def test_nearest_upsample_matches_jax_image_resize(rng):
    """``jax.image.resize(..., "nearest")`` at an integer factor 2 is
    ``F.interpolate(scale_factor=2, mode="nearest")``, exactly."""
    x = rng.standard_normal((2, 3, 5, 7)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, 3, 10, 14), "nearest")
    got = torch.nn.functional.interpolate(T(x), scale_factor=2, mode="nearest")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape,kind", [
    ((2, 3, 32, 32), "noise"), ((1, 3, 64, 48), "smooth"), ((2, 3, 8, 8), "small"),
    ((1, 1, 24, 24), "equal"), ((1, 3, 20, 20), "constant")])
def test_ssim_matches_jax(rng, shape, kind):
    """Images in [0, 1]: unrelated noise, a smooth image and its noisy copy,
    an image smaller than the window (no interior crop), identical images
    (SSIM 1) and constant images (variances clamp at 0)."""
    a = rng.random(shape).astype(np.float32)
    b = rng.random(shape).astype(np.float32)
    if kind == "smooth":
        yy, xx = np.meshgrid(np.linspace(0, 1, shape[2]), np.linspace(0, 1, shape[3]),
                             indexing="ij")
        a = np.broadcast_to(0.5 + 0.4 * np.sin(6 * yy) * np.cos(4 * xx),
                            shape).astype(np.float32)
        b = np.clip(a + 0.05 * (b - 0.5), 0, 1).astype(np.float32)
    elif kind == "equal":
        b = a.copy()
    elif kind == "constant":
        a, b = np.full(shape, 0.7, np.float32), np.full(shape, 0.2, np.float32)
    want = float(jlosses.ssim(jnp.asarray(a), jnp.asarray(b)))
    got = tlosses.ssim(T(a), T(b))
    assert got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-5, atol=1e-6)
    if kind == "equal":
        np.testing.assert_allclose(float(got), 1.0, atol=1e-6)


@pytest.mark.parametrize("name", ["l1_loss", "l2_loss", "mse_loss", "mse", "psnr"])
def test_image_losses_match_jax(rng, name):
    a = rng.random((3, 3, 16, 12)).astype(np.float32)
    b = rng.random((3, 3, 16, 12)).astype(np.float32)
    want = np.asarray(getattr(jlosses, name)(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(tlosses, name)(T(a), T(b))
    assert tuple(got.shape) == want.shape      # mse and psnr are per image, [B, 1]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sd_forward_captures_ip_attention_maps(rng, tiny_sd, dtype):
    """``capture_ip_attn_maps``: the ip stream's softmax probabilities
    [B, H, S, ip_tokens] in float32, outermost layer first, and the same
    noise prediction as without capture."""
    jcfg, tcfg, jp, tp = tiny_sd
    lat = rng.standard_normal((2, 4, 16, 16)).astype(np.float32)
    embeds = rng.standard_normal((4, 7, 16, 16)).astype(np.float32)
    t = np.asarray([10, 900])
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want, wmaps = jax.jit(
        lambda p: jsd.sd_forward(p, jnp.asarray(lat), jnp.asarray(t), jnp.asarray(embeds),
                                 jcfg, compute_dtype=jdt, capture_ip_attn_maps=True))(jp)
    got, maps = tsd.sd_forward(tp, T(lat), T(t), T(embeds), tcfg, compute_dtype=tdt,
                               capture_ip_attn_maps=True)
    plain = tsd.sd_forward(tp, T(lat), T(t), T(embeds), tcfg, compute_dtype=tdt)
    assert torch.equal(got, plain)
    tol = 1e-4 if dtype == "float32" else 3e-2
    _close(got, want, tol)
    # the tiny U-Net has cross-attention in its second down block (2), the
    # mid block (1) and the first up block (3)
    assert len(maps) == len(wmaps) == 6
    for m, w in zip(maps, wmaps):
        assert m.dtype == torch.float32 and tuple(m.shape) == w.shape
        assert m.shape[0] == 2 and m.shape[-1] == tcfg.unet.ip_num_tokens
        np.testing.assert_allclose(m.sum(-1).numpy(), 1.0, atol=1e-5)
        # probabilities: absolute tolerance
        np.testing.assert_allclose(m.numpy(), np.asarray(w), rtol=0, atol=tol)
