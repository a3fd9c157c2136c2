"""The port's joint train step (training/joint.py) against the JAX package's
on the CPU, at the reference's dry-run scale: the configuration of
``__graft_entry__._tiny_joint_setup`` (all-occupied grid, batch of two),
the same weights (JAX layout → ``convert.params_from_jax``), the same batch
and the same random draws (VAE eps, noise, timesteps, ray perturbation,
drawn from the keys JAX's ``forward_iteration`` splits).

Tolerances, float32 compute: the losses within 1e-5 relative; each
trainable gradient (hash table included) within 1e-4 of its leaf's largest
entry, since the two frameworks sum the U-Net's convolutions and attention
in other orders.  The NeRF color MLP's gradients are held to 3e-3: at the
±1e-4 table init σ·dt is ~1e-6, the color gradient is the render weight
α = 1 − exp(−σ·dt), and XLA's and PyTorch's float32 exp differ by an ulp
on ~4% of inputs, a few percent of such an α.  The AdamW update of every
trainable leaf within 1e-3·lr (the first Adam step is lr·g/(|g| + eps),
sensitive to g only where |g| is near eps).  bf16 compute is held to 3e-2
of the float32 reference.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as ge
from stable_nerf_tpu.config import HashGridConfig as JHashGridConfig
from stable_nerf_tpu.config import NeRFConfig as JNeRFConfig
from stable_nerf_tpu.config import SDConfig as JSDConfig
from stable_nerf_tpu.config import TrainConfig as JTrainConfig
from stable_nerf_tpu.data import rays as jrays
from stable_nerf_tpu.models.diffusion import DDIMScheduler as JDDIMScheduler
from stable_nerf_tpu.models.diffusion import sd_network as jsd
from stable_nerf_tpu.models.diffusion.unet import tiny_unet_config
from stable_nerf_tpu.models.diffusion.vae import VAEConfig as JVAEConfig
from stable_nerf_tpu.models.nerf import grid_init as jgrid_init
from stable_nerf_tpu.models.nerf import nerf_init as jnerf_init
from stable_nerf_tpu.training import joint as jj
from stable_nerf_tpu.utils import losses as jlosses
from stable_nerf_tpu.utils.pytree import combine, partition
from stable_nerf_tpu_torch import convert
from stable_nerf_tpu_torch.data import rays as trays
from stable_nerf_tpu_torch.models.diffusion.scheduler import DDIMScheduler
from stable_nerf_tpu_torch.models.diffusion.sd_network import (init_ip_from_unet,
                                                               sd_network_init)
from stable_nerf_tpu_torch.models.nerf.grid import OccupancyGridState
from stable_nerf_tpu_torch.models.nerf.network import nerf_init
from stable_nerf_tpu_torch.ops.hopper import scatter as tscatter
from stable_nerf_tpu_torch.training import joint as tj
from stable_nerf_tpu_torch.utils import losses as tlosses
from stable_nerf_tpu_torch.utils.tree import tree_leaves, tree_map

torch.set_num_threads(2)
B = 2


def _tiny_joint_config():
    """The configuration ``_tiny_joint_setup`` builds (its defaults: latent
    16, image 32, grid 32).  Built here rather than called: the setup's
    eager JAX init alone takes half a minute on the CPU."""
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
        train=JTrainConfig(max_steps_train=32, max_steps_eval=64))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def ref():
    """Both packages' inputs and the JAX float32 losses and gradients."""
    jcfg = _tiny_joint_config()
    tcfg = convert.config_from_jax(jcfg)
    # weights: random, made by the port from a seed, handed to JAX in its
    # layout and back to the port through params_from_jax
    seed_tree = {"sd": init_ip_from_unet(sd_network_init(0, tcfg.sd, device="cpu")),
                 "nerf": nerf_init(1, tcfg.nerf, device="cpu")}
    like = jax.eval_shape(lambda: {
        "sd": jsd.sd_network_init(jax.random.PRNGKey(0), jcfg.sd),
        "nerf": jnerf_init(jax.random.PRNGKey(1), jcfg.nerf)})
    jparams = jax.tree.map(jnp.asarray, convert.params_to_jax(seed_tree, like=like))
    grid = jgrid_init(jcfg.nerf)
    grid = grid._replace(occ=jnp.ones_like(grid.occ))
    sched = JDDIMScheduler.create(jcfg.sd.scheduler)
    batch = ge._make_batch(jcfg, B, jax.random.PRNGKey(1))
    key = jax.random.PRNGKey(3)

    # the draws forward_iteration makes from ``key`` (joint.py:221-284)
    enc = jcfg.latent_hw
    k_vae, k_noise, k_t, k_perturb = jax.random.split(key, 4)
    draws = {"vae_eps": jax.random.normal(k_vae, (2 * B, 4, enc, enc)),
             "noise": jax.random.normal(k_noise, (B, 4, enc, enc)),
             "timesteps": jax.random.randint(k_t, (B,), 0, 1000),
             "perturb": jax.random.uniform(k_perturb, (2 * B * enc * enc,))}

    mask = jj.joint_trainable_mask(jparams)
    trainable, frozen = partition(jparams, mask)

    def loss_fn(t):
        s, n, _ = jj.forward_iteration(combine(t, frozen), grid, batch, key, jcfg,
                                       sched, compute_dtype=jnp.float32)
        return s + n, (s, n)

    (_, (s, n)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(trainable)
    return {
        "jcfg": jcfg, "tcfg": tcfg, "jparams": jparams, "mask": mask,
        "trainable": trainable, "grads": grads, "losses": (float(s), float(n)),
        "port_params": lambda: convert.params_from_jax(_np(jparams), like=seed_tree),
        "grid": OccupancyGridState(*(torch.from_numpy(np.array(a)) for a in grid)),
        "sched": DDIMScheduler.create(tcfg.sd.scheduler, device="cpu"),
        "batch": {k: torch.from_numpy(np.array(v)) for k, v in batch.items()},
        "draws": {k: torch.from_numpy(np.array(v)) for k, v in draws.items()},
    }


def _port_grads(params, like):
    """The port's gradients in the JAX layout; frozen leaves must have none."""
    return convert.params_to_jax(
        tree_map(lambda p: p.grad if p.grad is not None else torch.zeros_like(p),
                 params), like=like)


def _grad_rtol(name):
    return 3e-3 if "color_mlp" in name else 1e-4


def _close_to_scale(got, want, rtol, name):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rtol * scale, err_msg=name)


def test_forward_losses_and_trainable_grads_match_jax(ref):
    params = ref["port_params"]()
    tmask = tj.joint_trainable_mask(params)
    for p, m in zip(tree_leaves(params), tree_leaves(tmask)):
        p.requires_grad_(bool(m) and p.is_floating_point())
    launches = tscatter.hash_scatter_add_per_level.launches
    s, n, aux = tj.forward_iteration(params, ref["grid"], ref["batch"], ref["tcfg"],
                                     ref["sched"], compute_dtype=torch.float32,
                                     draws=ref["draws"])
    (s + n).backward()
    # on the CPU the scatter runs its plain version: no kernel launch
    assert tscatter.hash_scatter_add_per_level.launches == launches
    js, jn = ref["losses"]
    np.testing.assert_allclose([float(s), float(n)], [js, jn], rtol=1e-5)
    assert aux["noise_pred"].shape == (B, 4, 16, 16)

    got = _port_grads(params, ref["jparams"])
    n_trainable = 0
    for (path, g), w, m in zip(jax.tree_util.tree_leaves_with_path(got),
                               jax.tree.leaves(ref["grads"], is_leaf=lambda x: x is None),
                               jax.tree.leaves(ref["mask"])):
        name = jax.tree_util.keystr(path)
        if m:
            n_trainable += 1
            _close_to_scale(g, w, _grad_rtol(name), name)
        else:
            assert w is None and not np.any(g), name
    # image_proj, downsampling, every to_k_ip/to_v_ip, and the NeRF
    assert n_trainable == len(jax.tree.leaves(ref["trainable"]))
    table = params["nerf"]["hash"]["table"].grad
    assert table is not None and float(table.abs().max()) > 0


@pytest.mark.parametrize("variant", ["plain", "nerf_lr", "grad_accum"])
def test_train_step_matches_optax_adamw(ref, variant):
    """One AdamW update (after two accumulated calls for ``grad_accum``)
    from the port's make_train_step against JAX's optax optimizer, fed the
    gradients the port's optimizer saw (the update arithmetic: each element
    within 1e-5·lr plus two float32 ulps of the param) and fed JAX's own
    gradients (end to end: each leaf's update within 1e-3 in L2 norm).
    Adam's first step lr·g/(|g| + eps) turns a tiny gradient difference
    into a large one where |g| is near eps, so the end-to-end check is a
    norm, and it skips the color MLP, whose gradients all sit there (the
    gradient test holds them)."""
    extra = {"plain": {}, "nerf_lr": {"nerf_lr": 3e-3},
             "grad_accum": {"grad_accum_steps": 2}}[variant]
    jtrain = dataclasses.replace(ref["jcfg"].train, **extra)
    tcfg = convert.config_from_jax(dataclasses.replace(ref["jcfg"], train=jtrain))
    trainable, frozen = partition(ref["jparams"], ref["mask"])
    opt = jj.make_optimizer(jtrain)

    @jax.jit
    def optax_step(grads):
        state = opt.init(trainable)
        for _ in range(jtrain.grad_accum_steps):
            # MultiSteps holds the params until the last call, so each
            # call sees the same params and the same gradients
            updates, state = opt.update(grads, state, trainable)
        return combine(optax.apply_updates(trainable, updates), frozen)

    params = ref["port_params"]()
    before = convert.params_to_jax(params, like=ref["jparams"])
    tmask = tj.joint_trainable_mask(params)
    topt = tj.make_optimizer(tcfg.train, params, tmask)
    assert len(topt.param_groups) == (2 if variant == "nerf_lr" else 1)
    seen = {}

    def record(*_):
        seen["grads"] = _port_grads(params, ref["jparams"])

    topt.register_step_pre_hook(record)
    step = tj.make_train_step(tcfg, ref["sched"], topt, compute_dtype=torch.float32,
                              device="cpu")
    for i in range(jtrain.grad_accum_steps):
        metrics = step(params, ref["grid"], ref["batch"], draws=ref["draws"])
        if i < jtrain.grad_accum_steps - 1:      # no update before the last call
            assert "grads" not in seen
    np.testing.assert_allclose(float(metrics["loss"]), sum(ref["losses"]), rtol=1e-5)

    got = convert.params_to_jax(params, like=ref["jparams"])
    want_own = optax_step(partition(jax.tree.map(jnp.asarray, seen["grads"]),
                                    ref["mask"])[0])
    want_ref = optax_step(ref["grads"])
    for (path, g), w_own, w_ref, b, m in zip(
            jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(want_own),
            jax.tree.leaves(want_ref), jax.tree.leaves(before),
            jax.tree.leaves(ref["mask"])):
        name = jax.tree_util.keystr(path)
        if not m:
            np.testing.assert_array_equal(g, b, err_msg=name)   # frozen: untouched
            continue
        lr = jtrain.nerf_lr if jtrain.nerf_lr and "'nerf'" in name else jtrain.lr
        # rtol: two float32 ulps of the param
        np.testing.assert_allclose(g, w_own, rtol=2 ** -22, atol=1e-5 * lr,
                                   err_msg=name)
        if "color_mlp" not in name:
            upd_ref = np.asarray(w_ref) - b
            err = np.linalg.norm((g - b) - upd_ref) / np.linalg.norm(upd_ref)
            assert err <= 1e-3, (name, err)


def test_frozen_bf16_storage_and_bf16_compute(ref):
    """The chip path's precision: frozen leaves stored in bf16, trainable
    leaves in float32, bf16 compute; the losses stay within bf16 rounding
    of the float32 reference and the step updates only the trainable
    leaves."""
    params = ref["port_params"]()
    tcfg = dataclasses.replace(ref["tcfg"], train=dataclasses.replace(
        ref["tcfg"].train, frozen_dtype="bfloat16"))
    mask = tj.joint_trainable_mask(params)
    params = tj.cast_frozen(params, mask, tcfg.train.frozen_dtype)
    for p, m in zip(tree_leaves(params), tree_leaves(mask)):
        assert p.dtype == (torch.float32 if m else torch.bfloat16)
    opt = tj.make_optimizer(tcfg.train, params, mask)
    frozen_before = [p.clone() for p, m in zip(tree_leaves(params),
                                               tree_leaves(mask)) if not m]
    step = tj.make_train_step(tcfg, ref["sched"], opt, compute_dtype=torch.bfloat16,
                              device="cpu")
    metrics = step(params, ref["grid"], ref["batch"], draws=ref["draws"])
    js, jn = ref["losses"]
    np.testing.assert_allclose([float(metrics["sd_loss"]), float(metrics["nerf_loss"])],
                               [js, jn], rtol=3e-2)
    frozen_after = [p for p, m in zip(tree_leaves(params), tree_leaves(mask)) if not m]
    assert all(torch.equal(a, b) for a, b in zip(frozen_before, frozen_after))
    with pytest.raises(ValueError, match="step built for"):
        tj.make_train_step(tcfg, ref["sched"], opt, device="meta")(
            params, ref["grid"], ref["batch"], draws=ref["draws"])


def test_forward_draws_from_generator(ref):
    """With no injected draws, the step draws from the generator: the same
    seed gives the same losses, and a draw without either raises."""
    params = ref["port_params"]()
    out = []
    for _ in range(2):
        g = torch.Generator().manual_seed(5)
        with torch.no_grad():
            s, n, _ = tj.forward_iteration(params, ref["grid"], ref["batch"],
                                           ref["tcfg"], ref["sched"],
                                           compute_dtype=torch.float32, generator=g)
        out.append((float(s), float(n)))
    assert out[0] == out[1] and all(np.isfinite(out[0]))
    with pytest.raises(ValueError, match="no generator"):
        tj.forward_iteration(params, ref["grid"], ref["batch"], ref["tcfg"],
                             ref["sched"], draws={"vae_eps": ref["draws"]["vae_eps"]})


@pytest.mark.parametrize("theta,phi", [(1.2, 0.3), (np.pi / 2, 4.0), (2.0, 6.1)])
def test_rand_poses_and_get_rays_match_jax(theta, phi):
    # a degenerate range pins the draw, so both packages build the same pose
    kw = dict(radius=2.0, theta_range=(theta, theta), phi_range=(phi, phi))
    want = np.asarray(jrays.rand_poses(jax.random.PRNGKey(0), 1, **kw))
    got = trays.rand_poses(torch.Generator().manual_seed(0), 1, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    intr = (6.0, 5.0, 4.0, 3.5)
    jr = jrays.get_rays(jnp.asarray(want), intr, 7, 9)
    tr = trays.get_rays(torch.from_numpy(want), intr, 7, 9)
    for k in ("rays_o", "rays_d"):
        np.testing.assert_allclose(tr[k].numpy(), np.asarray(jr[k]), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_array_equal(tr["inds"].numpy(), np.asarray(jr["inds"]))


def test_losses(rng):
    a, b = (rng.standard_normal((3, 17, 4)).astype(np.float32) for _ in range(2))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(float(tlosses.l1_loss(ta, tb)),
                               float(jlosses.l1_loss(a, b)), rtol=1e-6)
    np.testing.assert_allclose(float(tlosses.mse_loss(ta, tb)),
                               float(jlosses.mse_loss(a, b)), rtol=1e-6)


@pytest.mark.parametrize("field,cls", [
    ("mixed_precision", "train"), ("vae_scaling_factor", "sd"), ("bg_radius", "nerf")])
def test_config_conversion_refuses_unported_settings(field, cls):
    """A reference setting the port does not have converts only at its
    default, so a configuration is never silently changed.  (The U-Net's
    ``remat`` converts since the port has it: tests/test_torch_parallel.py.)"""
    jcfg = _tiny_joint_config()
    assert convert.config_from_jax(jcfg).train.max_steps_train == 32
    sub = {"train": jcfg.train, "sd": jcfg.sd.sd, "nerf": jcfg.nerf}[cls]
    changed = dataclasses.replace(sub, **{field: {"mixed_precision": "float32",
                                                  "vae_scaling_factor": 0.5,
                                                  "bg_radius": 2.0}[field]})
    with pytest.raises(TypeError, match=f"{field} = .* is not ported"):
        convert.config_from_jax(changed)
