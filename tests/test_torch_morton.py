"""The port's Morton order and bitfield packing (ops/morton.py) against the
JAX package's on the CPU, on the same numbers.  Tolerance: none, the
results are integers and bits and must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_nerf_tpu.ops import morton as jm
from stable_nerf_tpu_torch.ops import morton as tm


def _coords(rng, n=4096):
    c = rng.integers(0, 1024, (n, 3)).astype(np.int32)
    c[:8] = [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 1],
             [1023, 1023, 1023], [127, 127, 127], [5, 9, 31]]
    return c


def test_morton3d_and_invert_equal_jax(rng):
    c = _coords(rng)
    want = np.asarray(jm.morton3d(jnp.asarray(c)))
    got = tm.morton3d(torch.from_numpy(c))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    back = tm.morton3d_invert(got)
    assert back.dtype == torch.int32
    np.testing.assert_array_equal(back.numpy(), np.asarray(jm.morton3d_invert(jnp.asarray(want))))
    np.testing.assert_array_equal(back.numpy(), c)


def test_morton_covers_the_grid_once():
    """At grid 16 every cell gets a distinct index in [0, 16³)."""
    r = np.arange(16, dtype=np.int32)
    c = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    got = tm.morton3d(torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(np.sort(got), np.arange(16 ** 3))
    np.testing.assert_array_equal(got, np.asarray(jm.morton3d(jnp.asarray(c))))


@pytest.mark.parametrize("shape,thresh", [((64,), 0.5), ((2, 4096), 0.01), ((3, 8), -1.0)])
def test_packbits_and_unpackbits_equal_jax(rng, shape, thresh):
    grid = rng.uniform(-0.5, 1.0, shape).astype(np.float32)
    want = np.asarray(jm.packbits(jnp.asarray(grid), thresh))
    got = tm.packbits(torch.from_numpy(grid), thresh)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    bits = tm.unpackbits(got)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jm.unpackbits(jnp.asarray(want))))
    np.testing.assert_array_equal(bits.numpy(), grid > thresh)
