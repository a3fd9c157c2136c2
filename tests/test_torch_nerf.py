"""The port's NeRF (network, grid, dense and budgeted renderer) against the JAX package's
on the CPU: same weights (converted), same rays and perturbation.
float32 values and gradients within 1e-5 relative; the bf16 compute chain
within bf16 rounding (2e-2)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_nerf_tpu.config import HashGridConfig as JHashGridConfig
from stable_nerf_tpu.config import NeRFConfig as JNeRFConfig
from stable_nerf_tpu.models.nerf import grid as jgrid
from stable_nerf_tpu.models.nerf import network as jnet
from stable_nerf_tpu.models.nerf import renderer as jrender
from stable_nerf_tpu_torch import convert
from stable_nerf_tpu_torch.models.nerf import grid as tgrid
from stable_nerf_tpu_torch.models.nerf import network as tnet
from stable_nerf_tpu_torch.models.nerf import renderer as trender
from stable_nerf_tpu_torch.ops import encoding as tenc
from stable_nerf_tpu_torch.utils.tree import tree_map

torch.set_num_threads(2)
RTOL, ATOL = 1e-5, 1e-6


def _cfg(**kw):
    jc = JNeRFConfig(channel_dim=4, grid_size=16,
                     encoding_sigma=JHashGridConfig(n_levels=4, log2_hashmap_size=10,
                                                    base_resolution=4), **kw)
    return jc, convert.config_from_jax(jc)


def _params(tcfg, jcfg, table_scale=None):
    """Port init → JAX layout (NamedTuples rebuilt from the JAX tree's
    shape).  ``table_scale`` widens the ±1e-4 table init so densities are
    large enough to exercise compositing."""
    tp = tnet.nerf_init(0, tcfg, device="cpu")
    if table_scale is not None:
        tp["hash"]["table"].mul_(table_scale / 1e-4)
    like = jax.eval_shape(lambda: jnet.nerf_init(jax.random.PRNGKey(0), jcfg))
    return tp, jax.tree.map(jnp.asarray, convert.params_to_jax(tp, like=like))


def test_init_structure_and_conversion_roundtrip():
    jcfg, tcfg = _cfg()
    tp, jp = _params(tcfg, jcfg)
    assert isinstance(jp, jnet.NeRFParams)
    like = jax.eval_shape(lambda: jnet.nerf_init(jax.random.PRNGKey(0), jcfg))
    assert jax.tree.structure(jp) == jax.tree.structure(like)
    back = convert.params_from_jax(jp, like=tp)
    for a, b in zip(jax.tree.leaves(convert.params_to_jax(back)),
                    jax.tree.leaves(convert.params_to_jax(tp))):
        np.testing.assert_array_equal(a, b)
    grid = tgrid.grid_init(tcfg, device="cpu")
    ref = jgrid.grid_init(jcfg)
    for a, b in zip(grid, ref):
        assert tuple(a.shape) == b.shape


@pytest.mark.parametrize("activation", ["relu", "trunc_exp"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nerf_apply(rng, activation, dtype):
    jcfg, tcfg = _cfg(density_activation=activation)
    tp, jp = _params(tcfg, jcfg)
    x = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    d = rng.standard_normal((300, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    js, jc = jax.jit(jnet.nerf_apply, static_argnums=(3, 4))(
        jp, jnp.asarray(x), jnp.asarray(d), jcfg, getattr(jnp, dtype))
    ts, tc = tnet.nerf_apply(tp, torch.from_numpy(x), torch.from_numpy(d), tcfg,
                             getattr(torch, dtype))
    assert ts.dtype == torch.float32 and tc.dtype == torch.float32
    rtol, atol = (RTOL, ATOL) if dtype == "float32" else (2e-2, 2e-2)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=rtol, atol=atol)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=rtol, atol=atol)


def _render_inputs(rng, jcfg, n_rays):
    from stable_nerf_tpu.data.rays import get_rays, rand_poses

    rays = get_rays(rand_poses(jax.random.PRNGKey(4), 1, radius=2.0),
                    (8.0, 8.0, 4.0, 4.0), 8, n_rays // 8)
    occ = np.asarray(rng.random((1, jcfg.grid_size, jcfg.grid_size,
                                 jcfg.grid_size)) < 0.7)
    state = jgrid.grid_init(jcfg)._replace(occ=jnp.asarray(occ))
    return np.asarray(rays["rays_o"][0]), np.asarray(rays["rays_d"][0]), state


@pytest.mark.parametrize("eval_chunk", [2 ** 17, 256])
def test_render_values_and_grads(rng, monkeypatch, eval_chunk):
    jcfg, tcfg = _cfg(density_scale=3.0)
    tp, jp = _params(tcfg, jcfg, table_scale=1.0)
    o, d, jstate = _render_inputs(rng, jcfg, 64)
    key = jax.random.PRNGKey(7)
    noise = np.asarray(jax.random.uniform(key, (64,)))
    g_img = rng.standard_normal((64, 4)).astype(np.float32)
    g_ws = rng.standard_normal(64).astype(np.float32)
    kw = dict(bg_color=0.5, max_steps=32, eval_chunk=eval_chunk)

    def jloss(params):
        out = jrender.render(params, jstate, jnp.asarray(o), jnp.asarray(d), jcfg,
                             perturb_key=key, **kw)
        return jnp.sum(out["image"] * g_img) + jnp.sum(out["weights_sum"] * g_ws), out

    (_, jout), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)

    calls = []

    def counting(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    real = tenc.hash_scatter_add_per_level
    monkeypatch.setattr(tenc, "hash_scatter_add_per_level", counting)
    for t in [tp["hash"]["table"], *tp["sigma_mlp"]["layers"], *tp["color_mlp"]["layers"]]:
        t.requires_grad_(True)
    tstate = tgrid.OccupancyGridState(*(torch.from_numpy(np.array(a)) for a in jstate))
    out = trender.render(tp, tstate, torch.from_numpy(o), torch.from_numpy(d), tcfg,
                         perturb=torch.from_numpy(noise), **kw)
    ((out["image"] * torch.from_numpy(g_img)).sum()
     + (out["weights_sum"] * torch.from_numpy(g_ws)).sum()).backward()
    M = 64 * 32
    assert len(calls) == (M // eval_chunk if M > eval_chunk else 1)
    for k in ("image", "depth", "weights_sum"):
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(jout[k]),
                                   rtol=RTOL, atol=ATOL)
    assert 0.05 < float(out["weights_sum"].mean()) < 0.999
    tgrad = convert.params_to_jax(tree_map(lambda t: t.grad, tp), like=jgrad)
    for a, b in zip(jax.tree.leaves(tgrad), jax.tree.leaves(jgrad)):
        scale = max(float(np.abs(np.asarray(b)).max()), 1e-12)
        np.testing.assert_allclose(a / scale, np.asarray(b) / scale, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("budget", [512, 200])
def test_render_binding_budget_values_and_grads(rng, budget):
    """The compaction branch on a sparse grid (~30% of the cells occupied;
    364 of the 2048 lattice points valid without jitter, so 512 packs them
    all and 200 drops the rays' tails): image, depth, weights_sum and the
    hash-table and MLP gradients against JAX, at the dense test's
    tolerances."""
    jcfg, tcfg = _cfg(density_scale=3.0)
    tp, jp = _params(tcfg, jcfg, table_scale=1.0)
    o, d, jstate = _render_inputs(rng, jcfg, 64)
    occ = np.asarray(rng.random(jstate.occ.shape) < 0.3)
    jstate = jstate._replace(occ=jnp.asarray(occ))
    key = jax.random.PRNGKey(7)
    noise = np.asarray(jax.random.uniform(key, (64,)))
    g_img = rng.standard_normal((64, 4)).astype(np.float32)
    g_ws = rng.standard_normal(64).astype(np.float32)
    kw = dict(bg_color=0.5, max_steps=32, sample_budget=budget)

    def jloss(params):
        out = jrender.render(params, jstate, jnp.asarray(o), jnp.asarray(d), jcfg,
                             perturb_key=key, **kw)
        return jnp.sum(out["image"] * g_img) + jnp.sum(out["weights_sum"] * g_ws), out

    (_, jout), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    for t in [tp["hash"]["table"], *tp["sigma_mlp"]["layers"], *tp["color_mlp"]["layers"]]:
        t.requires_grad_(True)
    tstate = tgrid.OccupancyGridState(*(torch.from_numpy(np.array(a)) for a in jstate))
    out = trender.render(tp, tstate, torch.from_numpy(o), torch.from_numpy(d), tcfg,
                         perturb=torch.from_numpy(noise), **kw)
    ((out["image"] * torch.from_numpy(g_img)).sum()
     + (out["weights_sum"] * torch.from_numpy(g_ws)).sum()).backward()
    for k in ("image", "depth", "weights_sum"):
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(jout[k]),
                                   rtol=RTOL, atol=ATOL)
    assert 0.02 < float(out["weights_sum"].mean()) < 0.999
    tgrad = convert.params_to_jax(tree_map(lambda t: t.grad, tp), like=jgrad)
    for a, b in zip(jax.tree.leaves(tgrad), jax.tree.leaves(jgrad)):
        scale = max(float(np.abs(np.asarray(b)).max()), 1e-12)
        np.testing.assert_allclose(a / scale, np.asarray(b) / scale, rtol=RTOL, atol=ATOL)


def test_binding_sample_budget_is_not_ported():
    """Keeps its earlier name; what it holds now: a binding budget runs
    (the renderer no longer refuses it), a budget of at least the lattice
    is the dense path, and on an empty grid both render the background."""
    _, tcfg = _cfg()
    tp = tnet.nerf_init(0, tcfg, device="cpu")
    state = tgrid.grid_init(tcfg, device="cpu")
    rays = torch.zeros((4, 3)), torch.ones((4, 3))
    bound = trender.render(tp, state, *rays, tcfg, max_steps=8, sample_budget=16)
    dense = trender.render(tp, state, *rays, tcfg, max_steps=8, sample_budget=32)
    assert bound["image"].shape == dense["image"].shape == (4, 4)
    assert torch.equal(bound["image"], dense["image"])
    assert torch.equal(bound["image"], torch.ones((4, 4)))
