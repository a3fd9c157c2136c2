"""The port's learning harnesses against the JAX package's on the CPU:
scripts/fit_torch_nerf.py (the NeRF fit), scripts/pretrain_torch_tiny_vae.py
(the tiny VAE) and scripts/fit_torch_latent_ceiling.py (the latent
targets), each step driven through the scripts' own functions with the
JAX scripts' draws (ray indices, perturbs, refresh jitter, batch indices,
posterior eps) recomputed from their keys and injected.

Tolerances, float32: Adam against optax with a schedule within 1e-5·lr
per update (optax computes the bias correction in float32, torch in
float64).  The fit: losses within 1e-5 relative, each leaf's total update
within 5e-3 of its norm (measured: 2.4e-3 on the hash table; Adam at eps
1e-15 moves an entry by ~lr whatever the size of its gradient, so an
entry whose gradient is a rounding error can move the other way: a norm,
as the joint step's AdamW test holds it).  The pretrain: losses within
2e-5 relative at the first step and 1e-3 after (XLA's CPU float32 VAE
strays 2.2e-5 from float64, the port's 1e-6), each leaf's total update
within 3e-2 of its norm (Adam at eps 1e-8 flips entries whose gradient
is within that error of 0), the attention's key biases left out (softmax
ignores them: their gradient is rounding noise in both).  The ceiling's
targets within 3e-5 of their largest magnitude (tests/test_torch_demo.py
measures the VAE's error)."""

import dataclasses
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from stable_nerf_tpu.config import NeRFConfig as JNeRFConfig
from stable_nerf_tpu.data.dataset import StableNeRFDataset as JDataset
from stable_nerf_tpu.data.dataset import split_dataset as jsplit
from stable_nerf_tpu.data.preprocess import load_data as jload_data
from stable_nerf_tpu.models import nerf as jnerf
from stable_nerf_tpu.models.diffusion import sd_network as jsd
from stable_nerf_tpu.models.diffusion import vae as jvae
from stable_nerf_tpu_torch import convert
from stable_nerf_tpu_torch.models.diffusion import vae as tvae
from stable_nerf_tpu_torch.models.nerf.network import nerf_init
from stable_nerf_tpu_torch.utils.tree import tree_leaves, tree_leaves_with_path, tree_map

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.join(REPO, "datasets")
ARTIFACT = os.path.join(REPO, "runs", "demo_vae", "vae.npz")
FIT = chip_smoke.load_script("fit_torch_nerf")
PRETRAIN = chip_smoke.load_script("pretrain_torch_tiny_vae")
CEILING = chip_smoke.load_script("fit_torch_latent_ceiling")
T = torch.from_numpy


def _np(x):
    return np.array(x)


# --- Adam against optax ----------------------------------------------------

@pytest.mark.parametrize("kind", ["fit_exponential", "fit_constant", "pretrain_cosine"])
def test_adam_and_schedule_equal_optax(rng, kind):
    steps, lr = 6, 1e-2
    params = {"a": rng.standard_normal((40, 3)).astype(np.float32),
              "b": [rng.standard_normal(7).astype(np.float32)]}
    grads = [{"a": rng.standard_normal((40, 3)).astype(np.float32),
              "b": [rng.standard_normal(7).astype(np.float32) * 10.0 ** -i]}
             for i in range(steps)]
    tp = tree_map(lambda x: T(x.copy()), params)
    if kind == "pretrain_cosine":
        opt = optax.adam(optax.cosine_decay_schedule(lr, steps, alpha=0.02))
        args = PRETRAIN.build_parser().parse_args(["--lr", str(lr), "--steps", str(steps)])
        topt, sched = PRETRAIN.make_optimizer(tp, args)
    else:
        decay = 0.1 if kind == "fit_exponential" else 1.0
        opt = optax.adam(optax.exponential_decay(lr, steps, decay) if decay < 1 else lr,
                         b1=0.9, b2=0.99, eps=1e-15)
        topt, sched = FIT.make_optimizer(tp, lr, steps, decay)
        assert (sched is None) == (decay == 1.0)
    state = opt.init(params)
    jp = params
    for g in grads:
        u, state = opt.update(g, state, jp)
        jp = optax.apply_updates(jp, u)
        for x, gx in zip(tree_leaves(tp), tree_leaves(tree_map(T, g))):
            x.grad = gx.clone()
        topt.step()
        if sched is not None:
            sched.step()
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0,
                                   atol=steps * 1e-5 * lr + 2e-7)


# --- the NeRF fit ----------------------------------------------------------

FIT_ARGS = ["--size", "32", "--rays-per-batch", "256", "--max-steps", "64",
            "--grid-size", "32", "--steps", "3", "--data-root", ROOT]


def _jax_draws(key, jc):
    """The jitter update_extra_state's first (full) sweep draws from
    ``key`` (grid.py:148-155)."""
    k_branch, _ = jax.random.split(key)
    keys = jax.random.split(k_branch, jc.cascade)
    return {"noise": [_np(jax.random.uniform(keys[c], (jc.grid_size ** 3, 3),
                                             minval=-1.0, maxval=1.0))
                      for c in range(jc.cascade)]}


def _jax_fit(args, jcfg, jparams, views):
    """fit_nerf.py's loop for args.steps steps, its key stream, with its
    draws recorded: (params, losses, draws by step, grid state)."""
    cfg_sto = dataclasses.replace(jcfg, hash_stochastic=True,
                                  hash_stochastic_min_level=args.stochastic_min_level)
    opt = optax.adam(optax.exponential_decay(args.lr, args.steps, args.lr_decay),
                     b1=0.9, b2=0.99, eps=1e-15)
    opt_state = opt.init(jparams)
    ds = JDataset("synthetic", shape=(args.size,) * 2, encoded_shape=(args.size,) * 2,
                  root=ROOT)
    np.testing.assert_array_equal(np.asarray(ds.reference_poses), views["poses"].numpy())
    state = jax.jit(lambda s, p: jnerf.mark_untrained_grid(s, p, ds.intrinsic, jcfg))(
        jnerf.grid_init(jcfg), jnp.asarray(ds.reference_poses))
    pool_o, pool_d = (jnp.asarray(views[k].numpy()) for k in ("pool_o", "pool_d"))
    pool_gt = jnp.asarray(views["pool_gt"].numpy())

    def step_fn(stochastic):
        c = cfg_sto if stochastic else jcfg

        def train_step(params, opt_state, state, idx, k_perturb):
            o, d, gt = pool_o[idx], pool_d[idx], pool_gt[idx]

            def loss_fn(p):
                out = jnerf.render(p, state, o[None], d[None], c, bg_color=args.bg,
                                   max_steps=args.max_steps, perturb_key=k_perturb,
                                   compute_dtype=jnp.float32)
                return jnp.mean((out["image"][0] - gt) ** 2)

            loss, grads = jax.value_and_grad(loss_fn)(params)
            updates, opt_state = opt.update(grads, opt_state)
            return optax.apply_updates(params, updates), opt_state, loss
        return train_step

    update = jax.jit(lambda s, p, k: jnerf.update_extra_state(
        s, lambda x: jnerf.nerf_density(p, x, jcfg)["sigma"], k, jcfg))
    key = jax.random.PRNGKey(0)
    losses, draws = [], []
    for step in range(args.steps):
        d = {}
        if step % args.update_every == 0:
            key, k_grid = jax.random.split(key)
            state = update(state, jparams, k_grid)
            d["grid"] = _jax_draws(k_grid, jcfg)
        key, k = jax.random.split(key)
        k_idx, k_perturb = jax.random.split(k)
        idx = jax.random.randint(k_idx, (args.rays_per_batch,), 0, pool_o.shape[0])
        d["idx"], d["perturb"] = _np(idx), _np(jax.random.uniform(k_perturb,
                                                                  (args.rays_per_batch,)))
        warming = args.stochastic or step < args.stochastic_until
        jparams, opt_state, loss = step_fn(warming)(jparams, opt_state, state, idx, k_perturb)
        losses.append(float(loss))
        draws.append(d)
    return jparams, losses, draws, state


@pytest.mark.parametrize("extra", [[], ["--stochastic-until", "2",
                                        "--stochastic-min-level", "2"]])
def test_fit_steps_equal_jax(extra):
    """Three steps of the fit at 32² in float32: exact, and two hybrid
    warm-up steps (levels 0-1 exact, 2-15 one corner) before an exact
    one, each with the refresh at step 0.  JAX runs eagerly: its jitted
    step fuses o + t·d into a multiply-add that moves 43% of the march's
    positions by an ulp, and the stochastic encode hashes a position's
    bits into its corner.  (The scripts train in bf16; the joint step's
    tests hold bf16 against float32.)"""
    args = FIT.build_parser().parse_args(FIT_ARGS + extra)
    cfg = FIT.nerf_config(args)
    jcfg = JNeRFConfig(channel_dim=3, grid_size=args.grid_size,
                       hash_stochastic=args.stochastic,
                       hash_stochastic_min_level=args.stochastic_min_level,
                       density_activation=args.density_act)
    assert convert.config_from_jax(jcfg) == cfg
    views = FIT.load_views(args, torch.device("cpu"))
    params = nerf_init(3, cfg, device="cpu")
    like = jax.eval_shape(lambda: jnerf.nerf_init(jax.random.PRNGKey(0), jcfg))
    start = [x.clone() for x in tree_leaves(params)]
    jparams = jax.tree.map(jnp.asarray, convert.params_to_jax(params, like=like))
    jparams, jlosses, draws, jstate = _jax_fit(args, jcfg, jparams, views)

    state = FIT.init_state(cfg, views, torch.device("cpu"))
    opt, sched = FIT.make_optimizer(params, args.lr, args.steps, args.lr_decay)
    warm = FIT.warmup_config(cfg, args)
    losses = []
    for step, d in enumerate(draws):
        if "grid" in d:
            state = FIT.refresh(state, params, cfg,
                                draws={k: [T(a) for a in v] for k, v in d["grid"].items()})
        warming = args.stochastic or step < args.stochastic_until
        losses.append(float(FIT.train_step(
            params, opt, sched, state, views, warm if warming else cfg, T(d["idx"]).long(),
            T(d["perturb"]), bg=args.bg, max_steps=args.max_steps, loss=args.loss,
            budget=None, compute_dtype=torch.float32)))
    np.testing.assert_array_equal(state.occ.numpy(), np.asarray(jstate.occ))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    want = convert.params_from_jax(jax.tree.map(_np, jparams), like=params)
    for (name, a), b, s in zip(tree_leaves_with_path(params), tree_leaves(want), start):
        moved_t, moved_j = (a.detach() - s).numpy(), (b - s).numpy()
        scale = float(np.linalg.norm(moved_j))
        assert scale > 0, name
        assert float(np.linalg.norm(moved_t - moved_j)) <= 5e-3 * scale, name


def test_fit_refuses_stochastic_with_stochastic_until():
    args = FIT.build_parser().parse_args(FIT_ARGS + ["--stochastic", "--stochastic-until",
                                                     "5"])
    with pytest.raises(SystemExit) as e:
        FIT.run(args, torch.device("cpu"))
    assert "mutually exclusive" in str(e.value.code)


def test_fit_runs_end_to_end_and_its_final_line_parses(tmp_path, capsys):
    """Two steps of the script's main at 16² (refresh, warm-up switch,
    eval of two views, the saved images), then the FINAL line through
    scripts/bench_hybrid_sweep.py's own pattern."""
    FIT.main(["--size", "16", "--rays-per-batch", "128", "--max-steps", "32",
              "--grid-size", "16", "--steps", "3", "--stochastic-until", "1",
              "--sample-budget", "auto", "--log-every", "2", "--psnr-views", "2",
              "--data-root", ROOT, "--out", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "step 1: warmup over" in out
    with open(os.path.join(REPO, "scripts", "bench_hybrid_sweep.py")) as f:
        pattern = re.search(r're\.search\(r"(FINAL[^"]+)"', f.read()).group(1)
    m = re.search(pattern, out)
    assert m and np.isfinite(float(m.group(1)))
    assert re.search(r"FINAL: mean PSNR over 2 views = [\d.]+ dB \(per-view: \['[\d.]+', "
                     r"'[\d.]+'\]\)", out)
    saved = sorted(os.listdir(tmp_path))
    assert saved[0].startswith("gt.png") and any(s.startswith("pred_2.png") for s in saved)
    assert FIT.final_line([20.0, 19.5]) == ("FINAL: mean PSNR over 2 views = 19.75 dB "
                                            "(per-view: ['20.00', '19.50'])")


# --- the tiny-VAE pretrain -------------------------------------------------

def test_pretrain_steps_equal_jax():
    """Three steps at batch 4 from the same params, JAX's batch indices and
    posterior eps injected."""
    args = PRETRAIN.build_parser().parse_args(["--batch", "4", "--steps", "3",
                                               "--data-root", ROOT])
    cfg = PRETRAIN.vae_config(args.image_size, args.latent_size)
    jcfg = jvae.VAEConfig(block_out_channels=(32, 64, 128), layers_per_block=1,
                          norm_groups=8, scaling_factor=1.0)
    assert convert.config_from_jax(jcfg) == cfg
    train_images, test_images = PRETRAIN.load_split(args, torch.device("cpu"))
    images, _, _ = jload_data("synthetic", shape=(64, 64), root=ROOT)
    tr, _, te = jsplit(len(images), seed=0)
    np.testing.assert_array_equal(train_images.numpy(), np.asarray(images)[tr])
    np.testing.assert_array_equal(test_images.numpy(), np.asarray(images)[te])

    params = tvae.vae_init(torch.Generator().manual_seed(1), cfg)
    start = [x.clone() for x in tree_leaves(params)]
    jp = jax.tree.map(jnp.asarray, convert.params_to_jax(params))
    opt = optax.adam(optax.cosine_decay_schedule(args.lr, args.steps, alpha=0.02))
    opt_state = opt.init(jp)
    jtrain = jnp.asarray(np.asarray(images)[tr])

    @jax.jit
    def jstep(p, s, batch, k):
        def loss_fn(p):
            mean, logvar = jvae.vae_encode_moments(p, batch, jcfg)
            z = mean + jnp.exp(0.5 * logvar) * jax.random.normal(k, mean.shape)
            rec = jnp.mean((jvae.vae_decode(p, z, jcfg) - batch) ** 2)
            kl = 0.5 * jnp.mean(jnp.sum(mean ** 2 + jnp.exp(logvar) - 1.0 - logvar,
                                        axis=(1, 2, 3)))
            return rec + args.kl_weight * kl, (rec, kl)
        (loss, (rec, kl)), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s, loss, rec, kl

    topt, sched = PRETRAIN.make_optimizer(params, args)
    key = jax.random.PRNGKey(args.seed)
    key, _ = jax.random.split(key)              # the JAX script's init key
    for step in range(args.steps):
        key, k_idx, k_z = jax.random.split(key, 3)
        idx = jax.random.randint(k_idx, (args.batch,), 0, len(tr))
        jp, opt_state, jl, jr, jk = jstep(jp, opt_state, jtrain[idx], k_z)
        eps = _np(jax.random.normal(k_z, (args.batch, 4, 16, 16)))
        got = PRETRAIN.train_step(params, topt, sched, train_images[T(_np(idx)).long()],
                                  T(eps), cfg, args.kl_weight)
        np.testing.assert_allclose([float(x) for x in got], [float(jl), float(jr), float(jk)],
                                   rtol=2e-5 if step == 0 else 1e-3)
    want = convert.params_from_jax(jax.tree.map(_np, jp), like=params)
    for (name, a), b, s0 in zip(tree_leaves_with_path(params), tree_leaves(want), start):
        if "['to_k']['bias']" in name:
            continue            # a zero gradient: both move on rounding noise
        moved_t, moved_j = (a.detach() - s0).numpy(), (b - s0).numpy()
        assert (float(np.linalg.norm(moved_t - moved_j))
                <= 3e-2 * float(np.linalg.norm(moved_j))), name
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(params), start))
    p_te, lat = PRETRAIN.eval_recon(params, test_images, cfg)
    assert p_te.shape == (len(te), 1) and lat.shape == (len(te), 4, 16, 16)


def test_pretrain_main_writes_an_artifact_either_package_loads(tmp_path, capsys):
    out = str(tmp_path / "vae.npz")
    PRETRAIN.main(["--steps", "2", "--batch", "2", "--image-size", "32", "--latent-size",
                   "16", "--data-root", ROOT, "--out", out, "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    rec = json.loads(line)
    assert list(rec) == ["artifact", "recon_psnr_train", "recon_psnr_test", "latent_std",
                         "latent_mean", "image_size", "latent_size", "steps", "seed",
                         "wall_s", "scaling_factor"]
    jp, jcfg, jmeta = jvae.vae_load_npz(out)
    assert jcfg.block_out_channels == (32, 64)
    assert jcfg.scaling_factor == pytest.approx(1.0 / rec["latent_std"])
    assert jmeta == {k: rec[k] for k in jmeta}


def test_pretrain_refuses_sizes_as_jax():
    with pytest.raises(SystemExit, match="multiple of --latent-size"):
        PRETRAIN.vae_config(64, 24)
    with pytest.raises(SystemExit, match="power of two"):
        PRETRAIN.vae_config(48, 16)


# --- the latent ceiling ----------------------------------------------------

def test_ceiling_targets_from_the_committed_artifact_equal_jax():
    args = CEILING.build_parser().parse_args(["--vae-checkpoint", ARTIFACT])
    tg = CEILING.latent_targets(args, torch.device("cpu"))
    tp, tcfg, _ = tvae.vae_load_npz(ARTIFACT, device="cpu")
    jcfg = jvae.VAEConfig(**dataclasses.asdict(tcfg))
    sd_cfg = jsd.SDNetworkConfig(sd=jsd.SDConfig(latent_size=16, image_size=64), vae=jcfg)
    ds = JDataset("synthetic", shape=64, encoded_shape=16, root=ROOT, scale_intrinsics=True)
    assert len(tg["ds"]) == len(ds) == 64 and tg["latent"] == 16
    np.testing.assert_array_equal(tg["ds"].intrinsic, ds.intrinsic)
    np.testing.assert_allclose(tg["ds"].reference_rays["rays_d"],
                               np.asarray(ds.reference_rays["rays_d"]), atol=1e-6)
    jp = jax.tree.map(jnp.asarray, convert.params_to_jax(tp))
    want = jax.jit(lambda p, im: jsd.encode_images_mode({"vae": p}, im, sd_cfg))(
        jp, jnp.asarray(ds.reference_images))
    want = (np.asarray(want) + 1.0) / 2.0
    got = tg["target"].numpy()
    assert got.shape == (64, 4, 16, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-5 * float(np.abs(want).max()))
