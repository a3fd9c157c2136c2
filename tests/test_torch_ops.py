"""The port's ops (stable_nerf_tpu_torch/ops) against the JAX package's on
the CPU, same numpy inputs.  Integer outputs (hash rows, mip levels, voxel
and valid masks) must match exactly; float32 values and gradients within
1e-5 relative (the two frameworks sum and fuse in different orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_nerf_tpu.config import HashGridConfig as JHashGridConfig
from stable_nerf_tpu.ops import activation as jact
from stable_nerf_tpu.ops import composite as jcomp
from stable_nerf_tpu.ops import encoding as jenc
from stable_nerf_tpu.ops import marching as jmarch
from stable_nerf_tpu.ops import ray_ops as jray
from stable_nerf_tpu_torch.config import HashGridConfig
from stable_nerf_tpu_torch.ops import activation as tact
from stable_nerf_tpu_torch.ops import composite as tcomp
from stable_nerf_tpu_torch.ops import encoding as tenc
from stable_nerf_tpu_torch.ops import marching as tmarch
from stable_nerf_tpu_torch.ops import ray_ops as tray

torch.set_num_threads(2)
RTOL, ATOL = 1e-5, 1e-6

T = torch.from_numpy


def _rays(rng, n):
    o = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[0] = [0.0, 0.0, 1.0]            # zero components: inf slabs
    o[0] = [0.1, -0.2, -2.0]
    d[1] = [1.0, 0.0, 0.0]            # a miss
    o[1] = [-3.0, 5.0, 0.0]
    return o, d


def test_near_far_from_aabb_exact(rng):
    o, d = _rays(rng, 500)
    aabb = np.asarray([-1, -1, -1, 1, 1, 1], np.float32)
    jn, jf = jray.near_far_from_aabb(jnp.asarray(o), jnp.asarray(d), jnp.asarray(aabb))
    tn, tf = tray.near_far_from_aabb(T(o), T(d), T(aabb))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert tn[1] == np.float32(3.4028235e38)


def test_mip_levels_exact_including_zero_and_powers_of_two(rng):
    pos = rng.uniform(-4, 4, (400, 3)).astype(np.float32)
    pos[:6] = [[0, 0, 0], [0.5, 0, 0], [1, 0, 0], [2, 0, 0], [-0.25, 0, 0],
               [1e-30, 0, 0]]
    np.testing.assert_array_equal(tmarch.mip_from_pos(T(pos), 3).numpy(),
                                  np.asarray(jmarch.mip_from_pos(jnp.asarray(pos), 3)))
    for dt in [0.0, 2 * np.sqrt(3) / 256, 2 * np.sqrt(3) / 512, 1 / 64, 0.5]:
        dt32 = np.float32(dt)
        np.testing.assert_array_equal(
            tmarch.mip_from_dt(torch.tensor(dt32), 128, 3).numpy(),
            np.asarray(jmarch.mip_from_dt(jnp.asarray(dt32), 128, 3)))


@pytest.mark.parametrize("K", [None, 96])
def test_march_rays_lattice_exact(rng, K):
    o, d = _rays(rng, 64)
    aabb = np.asarray([-1, -1, -1, 1, 1, 1], np.float32)
    nears, fars = jray.near_far_from_aabb(jnp.asarray(o), jnp.asarray(d),
                                          jnp.asarray(aabb))
    occ = rng.random((1, 16, 16, 16)) < 0.6
    noise = rng.random(64).astype(np.float32)
    kw = dict(bound=1.0, cascade=1, grid_size=16, max_steps=64, n_samples=K)
    jp, jts, jdt, jv, jt0 = jmarch.march_rays_lattice(
        jnp.asarray(o), jnp.asarray(d), nears, fars, jnp.asarray(occ),
        noise=jnp.asarray(noise), **kw)
    tp, tts, tdt, tv, tt0 = tmarch.march_rays_lattice(
        T(o), T(d), T(np.asarray(nears)), T(np.asarray(fars)), T(occ),
        noise=T(noise), **kw)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tts.numpy(), np.asarray(jts))
    np.testing.assert_array_equal(tt0.numpy(), np.asarray(jt0))
    assert float(tdt) == float(jdt)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=RTOL, atol=ATOL)
    assert tv.any() and not tv.all()


def test_occupancy_lookup_exact_with_cascade(rng):
    pos = rng.uniform(-2, 2, (2000, 3)).astype(np.float32)
    occ = rng.random((2, 8, 8, 8)) < 0.5
    dt = np.float32(2 * np.sqrt(3) / 128)
    want = jmarch.occupancy_lookup(jnp.asarray(occ), jnp.asarray(pos),
                                   jnp.asarray(dt), 2.0, 2, 8)
    got = tmarch.occupancy_lookup(T(occ), T(pos), torch.tensor(dt), 2.0, 2, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _positions(rng, n):
    x = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    x[:4] = [[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [1, 0, 1]]
    return x


@pytest.mark.parametrize("kw", [
    dict(),                                                       # flagship
    dict(n_levels=4, log2_hashmap_size=12, base_resolution=4),    # tiny joint
])
def test_hash_rows_and_weights_exact(rng, kw):
    # eager JAX on purpose: under jit XLA contracts x·scale + 0.5 into an
    # FMA, which moves the weights by an ulp of the fine-level position
    x = _positions(rng, 3000)
    jc, tc = JHashGridConfig(**kw), HashGridConfig(**kw)
    ji, jw = jenc._hash_grid_indices_weights(jnp.asarray(x), jc)
    ti, tw = tenc._indices_weights_exact(T(x), tc, 0, tc.n_levels)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw)[..., 0])
    ji, _ = jenc._hash_grid_indices_stochastic(jnp.asarray(x), jc, 2)
    ti, _ = tenc._indices_weights_stochastic(T(x), tc, 2, tc.n_levels)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(
        tenc._stateless_uniform3(T(x), 3, 1).numpy(),
        np.asarray(jenc._stateless_uniform3(jnp.asarray(x), 3, 1)))


MODES = {
    "exact": dict(stochastic=False, stochastic_min_level=0),
    "stochastic": dict(stochastic=True, stochastic_min_level=0),
    "hybrid": dict(stochastic=True, stochastic_min_level=2),
}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("custom_bwd,grad_bf16", [(True, False), (True, True),
                                                  (False, False)])
def test_hash_grid_encode_values_and_table_grad(rng, mode, custom_bwd, grad_bf16):
    kw = dict(n_levels=4, log2_hashmap_size=10, base_resolution=4)
    jc, tc = JHashGridConfig(**kw), HashGridConfig(**kw)
    table = rng.uniform(-1, 1, (jc.n_levels * jc.table_size, 2)).astype(np.float32)
    x = _positions(rng, 257).reshape(257, 3)
    gout = rng.standard_normal((257, jc.output_dim)).astype(np.float32)
    opts = dict(custom_bwd=custom_bwd, grad_bf16=grad_bf16, **MODES[mode])

    def jloss(tab):
        out = jenc.hash_grid_encode(jenc.HashGridParams(tab), jnp.asarray(x), jc, **opts)
        return jnp.sum(out * gout), out

    (_, jout), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray(table))
    tab = T(table).requires_grad_(True)
    tout = tenc.hash_grid_encode({"table": tab}, T(x), tc, **opts)
    (tout * T(gout)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tab.grad.numpy(), np.asarray(jgrad), rtol=RTOL,
                               atol=ATOL)


def test_custom_bwd_gives_positions_zero_grad(rng):
    tc = HashGridConfig(n_levels=2, log2_hashmap_size=8, base_resolution=4)
    x = T(_positions(rng, 16)).requires_grad_(True)
    tab = torch.ones((2 * 256, 2), requires_grad=True)
    tenc.hash_grid_encode({"table": tab}, x, tc, custom_bwd=True).pow(2).sum().backward()
    assert torch.all(x.grad == 0)


def test_sh_encoding(rng):
    d = rng.uniform(0, 1, (100, 3)).astype(np.float32)
    for degree in (1, 2, 3, 4):
        np.testing.assert_allclose(tenc.sh_encoding(T(d), degree).numpy(),
                                   np.asarray(jenc.sh_encoding(jnp.asarray(d), degree)),
                                   rtol=RTOL, atol=ATOL)


def test_trunc_exp_value_and_clamped_grad():
    x = np.asarray([-30.0, -1.0, 0.0, 2.0, 20.0], np.float32)
    jv, jg = jax.value_and_grad(lambda v: jnp.sum(jact.trunc_exp(v)))(jnp.asarray(x))
    tx = T(x).requires_grad_(True)
    tv = tact.trunc_exp(tx)
    tv.sum().backward()
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jact.trunc_exp(x)),
                               rtol=RTOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg), rtol=RTOL)


def test_composite_values_and_closed_form_grads(rng):
    N, K, C = 32, 48, 4
    # large densities on some rays trigger the early-exit mask
    sigmas = (rng.random((N, K)) * np.where(rng.random((N, 1)) < 0.5, 200, 5)
              ).astype(np.float32)
    rgbs = rng.random((N, K, C)).astype(np.float32)
    valid = rng.random((N, K)) < 0.8
    t0 = rng.uniform(0.2, 1.0, N).astype(np.float32)
    dt = np.float32(2 * np.sqrt(3) / K)
    ts = (t0[:, None] + np.arange(K, dtype=np.float32)[None] * dt).astype(np.float32)
    g_ws = rng.standard_normal(N).astype(np.float32)
    g_img = rng.standard_normal((N, C)).astype(np.float32)
    g_depth = rng.standard_normal(N).astype(np.float32)

    def jloss(s, r):
        ws, depth, img = jcomp.composite_rays(s, r, dt, jnp.asarray(ts),
                                              jnp.asarray(t0), jnp.asarray(valid))
        return jnp.sum(ws * g_ws) + jnp.sum(img * g_img) + jnp.sum(depth * g_depth), \
            (ws, depth, img)

    (_, jout), (jgs, jgr) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(sigmas), jnp.asarray(rgbs))
    ts_, tr_ = T(sigmas).requires_grad_(True), T(rgbs).requires_grad_(True)
    tout = tcomp.composite_rays(ts_, tr_, dt, T(ts), T(t0), T(valid))
    ((tout[0] * T(g_ws)).sum() + (tout[2] * T(g_img)).sum()
     + (tout[1] * T(g_depth)).sum()).backward()
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ts_.grad.numpy(), np.asarray(jgs), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tr_.grad.numpy(), np.asarray(jgr), rtol=RTOL, atol=ATOL)
