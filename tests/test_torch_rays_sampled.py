"""The port's sampled ``get_rays`` modes (stable_nerf_tpu_torch/data/rays.py)
against the JAX package's on the CPU: N uniform rays, patches, and the
error-map Gumbel-top-k without replacement.  JAX's draws are recomputed
from its key and injected, so the sampled indices must be equal exactly
and the rays within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_nerf_tpu.data import rays as jrays
from stable_nerf_tpu_torch.data import rays as trays

torch.set_num_threads(2)
INTR = (40.0, 44.0, 15.5, 17.0)
H, W = 32, 36


def _poses(rng, b):
    q, _ = np.linalg.qr(rng.standard_normal((b, 3, 3)))
    poses = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    poses[:, :3, :3] = q
    poses[:, :3, 3] = rng.uniform(-1, 1, (b, 3))
    return poses.astype(np.float32)


def _compare(j, t):
    assert set(j) == set(t)
    for k in ("inds", "inds_coarse"):
        if k in j:
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))
    for k in ("rays_o", "rays_d"):
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), rtol=1e-6, atol=1e-6)


def test_uniform_rays_equal_jax_with_its_draw(rng):
    poses, key, N = _poses(rng, 3), jax.random.PRNGKey(4), 200
    j = jrays.get_rays(jnp.asarray(poses), INTR, H, W, N=N, key=key)
    inds = np.array(jax.random.randint(key, (N,), 0, H * W))
    t = trays.get_rays(torch.from_numpy(poses), INTR, H, W, N=N,
                       draws={"inds": torch.from_numpy(inds)})
    _compare(j, t)
    assert t["inds"].shape == (3, N)


@pytest.mark.parametrize("patch_size,N", [(4, 64), (3, 40)])
def test_patch_rays_equal_jax_with_its_draws(rng, patch_size, N):
    poses, key = _poses(rng, 2), jax.random.PRNGKey(7)
    j = jrays.get_rays(jnp.asarray(poses), INTR, H, W, N=N, key=key, patch_size=patch_size)
    kx, ky = jax.random.split(key)
    n_patch = N // patch_size ** 2
    draws = {"inds_x": np.asarray(jax.random.randint(kx, (n_patch,), 0, H - patch_size)),
             "inds_y": np.asarray(jax.random.randint(ky, (n_patch,), 0, W - patch_size))}
    t = trays.get_rays(torch.from_numpy(poses), INTR, H, W, N=N,
                       patch_size=patch_size,
                       draws={k: torch.from_numpy(v) for k, v in draws.items()})
    _compare(j, t)
    assert t["inds"].shape == (2, n_patch * patch_size ** 2)


@pytest.mark.parametrize("hw", [(256, 256), (100, 130)])
def test_error_map_rays_equal_jax_with_its_draws(rng, hw):
    h, w = hw
    B, N = 2, 300
    poses, key = _poses(rng, B), jax.random.PRNGKey(11)
    em = rng.uniform(0.0, 1.0, (B, 128 * 128)).astype(np.float32)
    em[:, :1000] = 0.0                               # cells of log(1e-12)
    j = jrays.get_rays(jnp.asarray(poses), INTR, h, w, N=N, key=key,
                       error_map=jnp.asarray(em))
    kc, kx, ky = jax.random.split(key, 3)
    draws = {"gumbel": np.stack([np.asarray(jax.random.gumbel(k, (128 * 128,)))
                                 for k in jax.random.split(kc, B)]),
             "ux": np.asarray(jax.random.uniform(kx, (B, N))),
             "uy": np.asarray(jax.random.uniform(ky, (B, N)))}
    t = trays.get_rays(torch.from_numpy(poses), INTR, h, w, N=N,
                       error_map=torch.from_numpy(em),
                       draws={k: torch.from_numpy(v) for k, v in draws.items()})
    _compare(j, t)
    # without replacement: no coarse cell twice in a row of the batch
    for b in range(B):
        assert len(set(t["inds_coarse"][b].tolist())) == N


def test_sampled_modes_draw_from_the_generator_and_need_one(rng):
    poses = torch.from_numpy(_poses(rng, 1))
    em = torch.ones((1, 128 * 128))
    for kw in ({}, {"patch_size": 2}, {"error_map": em}):
        a = trays.get_rays(poses, INTR, H, W, N=64,
                           generator=torch.Generator().manual_seed(3), **kw)
        b = trays.get_rays(poses, INTR, H, W, N=64,
                           generator=torch.Generator().manual_seed(3), **kw)
        torch.testing.assert_close(a["inds"], b["inds"], rtol=0, atol=0)
        assert int(a["inds"].max()) < H * W
        with pytest.raises(ValueError, match="generator"):
            trays.get_rays(poses, INTR, H, W, N=64, **kw)
    # N beyond the image is cut to H·W; -1 is every pixel, as before
    assert trays.get_rays(poses, INTR, 4, 4, N=100,
                          generator=torch.Generator())["inds"].shape == (1, 16)
    full = trays.get_rays(poses, INTR, H, W)
    j = jrays.get_rays(jnp.asarray(poses.numpy()), INTR, H, W)
    _compare(j, full)
