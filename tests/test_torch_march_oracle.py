"""The port's iterative march (stable_nerf_tpu_torch/ops/marching.py::
march_rays_iterative, the CUDA DDA step for step) against the JAX
package's on the CPU, and against the port's own masked lattice at
dt_gamma = 0 (the equivalence the lattice march rests on).  The two
iterative marches perform the same float32 operations: valid masks and
sample counts equal exactly, positions and distances within 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_nerf_tpu.ops import marching as jmarch
from stable_nerf_tpu.ops.ray_ops import near_far_from_aabb as jnear_far
from stable_nerf_tpu_torch.ops import marching as tmarch

torch.set_num_threads(2)

PATTERNS = {
    "full": lambda rng, H: np.ones((H, H, H), bool),
    "random": lambda rng, H: rng.uniform(size=(H, H, H)) < 0.3,
    "slab": lambda rng, H: np.pad(
        np.ones((H, H, H // 4), bool), ((0, 0), (0, 0), (H // 2, H - H // 2 - H // 4))),
}


def _setup(pattern, H=32, n_rays=16, cascade=1, seed=0):
    rng = np.random.default_rng(seed)
    grid = np.stack([PATTERNS[pattern](rng, H) for _ in range(cascade)])
    o = rng.uniform(-0.5, 0.5, (n_rays, 3)).astype(np.float32)
    o[:, 2] = -3.0
    target = rng.uniform(-0.5, 0.5, (n_rays, 3)).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[0] = [0.0, 0.0, 1.0]                     # zero components: inf slabs, NaN skips
    bound = float(2 ** (cascade - 1))
    aabb = np.asarray([-bound] * 3 + [bound] * 3, np.float32)
    nears, fars = (np.array(a) for a in jnear_far(jnp.asarray(o), jnp.asarray(d),
                                                    jnp.asarray(aabb)))
    return grid, o, d, nears, fars, bound


def _both(grid, o, d, nears, fars, **kw):
    noise = kw.pop("noise", None)
    j = jmarch.march_rays_iterative(jnp.asarray(o), jnp.asarray(d), jnp.asarray(nears),
                                    jnp.asarray(fars), jnp.asarray(grid),
                                    noise=None if noise is None else jnp.asarray(noise), **kw)
    t = tmarch.march_rays_iterative(torch.from_numpy(o), torch.from_numpy(d),
                                    torch.from_numpy(nears), torch.from_numpy(fars),
                                    torch.from_numpy(grid),
                                    noise=None if noise is None else torch.from_numpy(noise),
                                    **kw)
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


@pytest.mark.parametrize("pattern,dt_gamma,cascade", [
    ("full", 0.0, 1), ("random", 0.0, 1), ("slab", 0.0, 1), ("random", 0.05, 1),
    ("slab", 0.0, 2), ("random", 0.02, 2)])
def test_iterative_equals_jax(pattern, dt_gamma, cascade):
    grid, o, d, nears, fars, bound = _setup(pattern, cascade=cascade)
    noise = np.random.default_rng(1).uniform(size=o.shape[0]).astype(np.float32)
    j, t = _both(grid, o, d, nears, fars, bound=bound, cascade=cascade, grid_size=32,
                 max_steps=64, dt_gamma=dt_gamma, noise=noise)
    xyz_j, ts_j, dts_j, dd_j, valid_j, t0_j = j
    xyz_t, ts_t, dts_t, dd_t, valid_t, t0_t = t
    np.testing.assert_array_equal(valid_t, valid_j)
    assert valid_t.sum() > 0
    np.testing.assert_allclose(t0_t, t0_j, rtol=1e-6)
    for a, b in ((xyz_t, xyz_j), (ts_t, ts_j), (dts_t, dts_j), (dd_t, dd_j)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pattern", list(PATTERNS))
def test_iterative_samples_lie_on_the_lattice_at_dt_gamma_zero(pattern):
    """Every iterative sample is a lattice sample; at most 2 a ray more on
    the lattice (the analytic skip can pass a point on a voxel boundary;
    serial t += dt rounds apart from t0 + k·dt at the far edge)."""
    grid, o, d, nears, fars, _ = _setup(pattern)
    args = [torch.from_numpy(a) for a in (o, d, nears, fars, grid)]
    kw = dict(bound=1.0, cascade=1, grid_size=32, max_steps=64)
    _, ts_l, dt, valid_l, t0_l = tmarch.march_rays_lattice(*args, **kw)
    _, ts_i, dts_i, _, valid_i, t0_i = tmarch.march_rays_iterative(*args, **kw)
    torch.testing.assert_close(t0_i, t0_l)
    nl, ni = valid_l.sum(-1).numpy(), valid_i.sum(-1).numpy()
    assert np.all(nl - ni >= 0) and np.all(nl - ni <= 2), (nl, ni)
    assert np.mean(nl == ni) >= 0.7
    for r in range(o.shape[0]):
        lat = ts_l[r][valid_l[r]].numpy()
        for t in ts_i[r][: ni[r]].numpy():
            assert np.min(np.abs(lat - t)) < 1e-4
        np.testing.assert_allclose(dts_i[r][: ni[r]].numpy(), float(dt), rtol=1e-6)


def test_iterative_iteration_cap_and_sample_count():
    """``iter_max`` cuts the march as JAX's does; ``n_samples`` below
    max_steps keeps writing into the last slot."""
    grid, o, d, nears, fars, _ = _setup("full", n_rays=4)
    for kw in (dict(iter_max=10), dict(n_samples=8)):
        j, t = _both(grid, o, d, nears, fars, bound=1.0, cascade=1, grid_size=32,
                     max_steps=64, **kw)
        for a, b in zip(t, j):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    assert t[4].shape == (4, 8)
