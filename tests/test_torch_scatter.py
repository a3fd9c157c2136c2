"""The port's hash-table gradient scatter (ops/hopper/scatter.py) against
the JAX package's Pallas kernels in interpret mode and its XLA path.

On the CPU the wrapper runs the plain version (masked index_add_ in f32);
the CUDA kernel is compared with it on the card in test_torch_cuda.py.
Cases mirror tests/test_pallas_v2_kernels.py and tests/test_pallas_scatter.py:
random rows, a hot row with padding, block boundaries, payload_bf16 and a
K2-shaped (1024-multiple, not 4096-multiple) table.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_nerf_tpu.ops.pallas.scatter import hash_scatter_add_per_level as jax_per_level
from stable_nerf_tpu.ops.pallas.scatter_v2 import sorted_block_scatter_add_v2
from stable_nerf_tpu_torch.ops.hopper.scatter import (hash_scatter_add_per_level,
                                                      hash_scatter_add_plain)

torch.set_num_threads(2)

# f32 sums in another order: the port's index_add_ against XLA's scatter
# (and against the Pallas kernel's hi/lo bf16-split accumulation, ~1e-5
# relative)
RTOL, ATOL = 1e-4, 1e-5


def _port_flat(idx, upd, T, payload_bf16=False):
    """The port's wrapper on flat [M] rows / [M, F] updates (one level)."""
    idx_t = torch.from_numpy(np.ascontiguousarray(idx, np.int32)).reshape(-1, 1, 1)
    upd_t = torch.from_numpy(np.ascontiguousarray(upd, np.float32))
    upd_t = upd_t.reshape(-1, 1, 1, upd.shape[-1])
    return hash_scatter_add_per_level(idx_t, upd_t, 1, T, payload_bf16).numpy()


def _sorted(idx, upd):
    order = np.argsort(idx, kind="stable")
    return jnp.asarray(idx[order]), jnp.asarray(upd[order])


def test_matches_v2_kernel_random_rows(rng):
    T, F, M = 8192, 2, 3000
    idx = rng.integers(0, T, M).astype(np.int32)
    upd = rng.standard_normal((M, F)).astype(np.float32)
    want = np.asarray(sorted_block_scatter_add_v2(*_sorted(idx, upd), T,
                                                  interpret=True))
    got = _port_flat(idx, upd, T)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    untouched = np.ones(T, bool)
    untouched[idx] = False
    assert np.all(got[untouched] == 0.0)


def test_hot_row_and_padding_dropped():
    T, F, M = 4096, 2, 4000
    idx = np.concatenate([np.full(M - 100, 77), np.full(100, T)]).astype(np.int32)
    upd = np.ones((M, F), np.float32)
    want = np.asarray(sorted_block_scatter_add_v2(jnp.asarray(idx), jnp.asarray(upd),
                                                  T, interpret=True))
    got = _port_flat(idx, upd, T)
    assert got[77, 0] == M - 100 and got.sum() == (M - 100) * F
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_block_boundaries():
    T, F = 8192, 2
    idx = np.asarray([0, 4095, 4096, 4097, 8191], np.int32)
    upd = np.arange(10, dtype=np.float32).reshape(5, F)
    want = np.asarray(sorted_block_scatter_add_v2(jnp.asarray(idx), jnp.asarray(upd),
                                                  T, interpret=True))
    got = _port_flat(idx, upd, T)
    np.testing.assert_array_equal(got[idx], upd)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("L,T,payload_bf16", [
    (4, 256, False),      # the JAX per-level test's shape
    (3, 1024, False),     # K2-shaped: 3·1024 is not a multiple of 4096
    (3, 64, True),        # payload_bf16
    (4, 4096, True),
])
def test_per_level_matches_jax(rng, L, T, payload_bf16):
    M, C, F = 500, 8, 2
    local = rng.integers(0, T, (M, L, C))
    idx = (local + np.arange(L)[None, :, None] * T).astype(np.int32)
    idx[0, 0, :2] = L * T          # padding rows, dropped by both
    upd = (rng.standard_normal((M, L, C, F)) * 10).astype(np.float32)
    want = np.asarray(jax_per_level(jnp.asarray(idx), jnp.asarray(upd), L, T,
                                    use_pallas=False, payload_bf16=payload_bf16))
    got = hash_scatter_add_per_level(torch.from_numpy(idx), torch.from_numpy(upd),
                                     L, T, payload_bf16).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_payload_bf16_rounds_each_update_to_nearest_even():
    # 1 + 2^-8 lies halfway between bf16 neighbours 1 and 1 + 2^-7: ties go
    # to the even mantissa (1.0); 1 + 3·2^-8 rounds up to 1 + 2^-6
    upd = np.asarray([[1 + 2 ** -8, 1 + 3 * 2 ** -8]], np.float32)
    got = _port_flat(np.asarray([0], np.int32), upd, 4, payload_bf16=True)
    np.testing.assert_array_equal(got[0], [1.0, 1 + 2 ** -6])
    ref = np.asarray(jnp.asarray(upd).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(got[0], ref[0])


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity"])
def test_wrapper_rejects_bad_inputs(bad):
    idx = torch.zeros((4, 2, 8), dtype=torch.int32)
    upd = torch.zeros((4, 2, 8, 2))
    if bad == "dtype":
        idx = idx.long()
    elif bad == "shape":
        upd = upd[:, :1]
    else:
        upd = torch.zeros((4, 2, 2, 8)).transpose(2, 3)
    with pytest.raises((TypeError, ValueError)):
        hash_scatter_add_per_level(idx, upd, 2, 16)
