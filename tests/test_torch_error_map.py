"""The port's error map (stable_nerf_tpu_torch/models/nerf/error_map.py)
against the JAX package's on the CPU: init, the EMA update (exact to
float32 rounding), and the loop the two make with get_rays' error-map
mode, JAX's draws injected."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_nerf_tpu.data.rays import get_rays as jget_rays
from stable_nerf_tpu.models.nerf import error_map as jem
from stable_nerf_tpu_torch.data.rays import get_rays as tget_rays
from stable_nerf_tpu_torch.models.nerf import error_map as tem

torch.set_num_threads(2)


def test_init_equals_jax():
    t = tem.error_map_init(3, 16, device="cpu")
    np.testing.assert_array_equal(t.numpy(), np.asarray(jem.error_map_init(3, 16)))
    assert t.shape == (3, 256) and t.dtype == torch.float32


@pytest.mark.parametrize("error_kind", ["per_ray", "scalar"])
def test_update_equals_jax(rng, error_kind):
    em = rng.uniform(0, 1, (4, 64)).astype(np.float32)
    index = np.asarray([2, 0])
    inds = np.stack([rng.permutation(64)[:10] for _ in range(2)])
    err = (rng.uniform(0, 1, (2, 10)).astype(np.float32) if error_kind == "per_ray"
           else np.float32(0.25))
    want = jem.update_error_map(jnp.asarray(em), jnp.asarray(index), jnp.asarray(inds),
                                jnp.asarray(err))
    got = tem.update_error_map(torch.from_numpy(em), torch.from_numpy(index),
                               torch.from_numpy(inds), torch.as_tensor(err))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got[[1, 3]].numpy(), em[[1, 3]])     # rows not in the batch
    assert not np.shares_memory(got.numpy(), em)


def test_sample_then_update_loop_equals_jax(rng):
    """Three rounds of sampling on the map and updating it from a per-ray
    error, in both packages."""
    B, N, h = 2, 64, 128
    poses = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    intr = (100.0, 100.0, 64.0, 64.0)
    jmap, tmap = jem.error_map_init(B), tem.error_map_init(B, device="cpu")
    index = np.arange(B)
    key = jax.random.PRNGKey(0)
    for _ in range(3):
        key, k = jax.random.split(key)
        j = jget_rays(jnp.asarray(poses), intr, h, h, N=N, key=k, error_map=jmap)
        kc, kx, ky = jax.random.split(k, 3)
        draws = {"gumbel": np.stack([np.asarray(jax.random.gumbel(kk, (128 * 128,)))
                                     for kk in jax.random.split(kc, B)]),
                 "ux": np.asarray(jax.random.uniform(kx, (B, N))),
                 "uy": np.asarray(jax.random.uniform(ky, (B, N)))}
        t = tget_rays(torch.from_numpy(poses), intr, h, h, N=N, error_map=tmap,
                      draws={kk: torch.from_numpy(v) for kk, v in draws.items()})
        np.testing.assert_array_equal(t["inds_coarse"].numpy(), np.asarray(j["inds_coarse"]))
        err = (np.asarray(j["inds"]) % 7 / 7.0).astype(np.float32)
        jmap = jem.update_error_map(jmap, jnp.asarray(index), j["inds_coarse"],
                                    jnp.asarray(err))
        tmap = tem.update_error_map(tmap, torch.from_numpy(index), t["inds_coarse"],
                                    torch.from_numpy(err))
        np.testing.assert_allclose(tmap.numpy(), np.asarray(jmap), rtol=1e-6)
