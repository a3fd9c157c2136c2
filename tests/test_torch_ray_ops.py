"""The port's ``sph_from_ray`` (stable_nerf_tpu_torch/ops/ray_ops.py) against
the JAX package's on the CPU within 1e-5, and the ``ops`` package's
exports against the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stable_nerf_tpu.ops as jops
import stable_nerf_tpu_torch.ops as tops
from stable_nerf_tpu.ops.ray_ops import sph_from_ray as jsph
from stable_nerf_tpu_torch.ops.ray_ops import sph_from_ray as tsph

torch.set_num_threads(2)


@pytest.mark.parametrize("radius", [1.5, 4.0])
def test_sph_from_ray_equals_jax(rng, radius):
    o = rng.uniform(-0.8, 0.8, (300, 3)).astype(np.float32)
    d = rng.standard_normal((300, 3)).astype(np.float32)
    d[:100] /= np.linalg.norm(d[:100], axis=-1, keepdims=True)   # unit and not
    d[0] = [0, 1, 0]
    d[1] = [0, -1, 0]
    d[2] = [1, 0, 0]
    want = np.asarray(jsph(jnp.asarray(o), jnp.asarray(d), radius))
    got = tsph(torch.from_numpy(o), torch.from_numpy(d), radius).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert got.shape == (300, 2) and np.all(np.abs(got) <= 1 + 1e-6)


def test_sph_from_ray_batched_shape_and_axes():
    o = torch.zeros((2, 3, 3))
    d = torch.tensor([[0.0, 1.0, 0.0], [0.0, -1.0, 0.0], [1.0, 0.0, 0.0]]).expand(2, 3, 3)
    got = tsph(o, d, 2.0)
    assert got.shape == (2, 3, 2)
    torch.testing.assert_close(got[0, :, 0], torch.tensor([-1.0, 1.0, 0.0]))
    want = np.asarray(jsph(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), 2.0))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_ops_exports_equal_jax():
    assert sorted(tops.__all__) == sorted(jops.__all__)
    for name in tops.__all__:
        assert callable(getattr(tops, name)), name
    assert tops.sph_from_ray is tsph
