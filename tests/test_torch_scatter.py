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


@pytest.mark.parametrize("T", [8192, 4096])
def test_negative_rows_dropped_as_the_pallas_kernel_drops_them(rng, T):
    """Rows below 0 are dropped by the TPU kernel K1 (sorted_block_scatter_add_v2)
    exactly as by the port; only JAX's XLA route wraps them (row −5 lands
    on T − 5 there).  Negative, in-range and padding (≥ T) rows together,
    equal to 1e-6: the updates are multiples of 1/4 that bf16 holds
    exactly, so the kernel's hi/lo bf16 split sums them without error."""
    F = 2
    idx = np.concatenate([[-5, -1, -T, 3, 3, 100, T - 1, T, T + 808],
                          rng.integers(-64, T + 64, 2000)]).astype(np.int32)
    upd = (rng.integers(-16, 17, (idx.size, F)) / 4).astype(np.float32)
    upd[0] = [100.0, -100.0]                 # the row −5 update, large
    want = np.asarray(sorted_block_scatter_add_v2(*_sorted(idx, upd), T, interpret=True))
    got = _port_flat(idx, upd, T)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    kept = (idx >= 0) & (idx < T)
    np.testing.assert_allclose(got, _port_flat(idx[kept], upd[kept], T), rtol=1e-6,
                               atol=1e-6)
    # the XLA route differs from both by the negative rows, wrapped by T
    xla = np.asarray(jax_per_level(jnp.asarray(idx).reshape(-1, 1, 1),
                                   jnp.asarray(upd).reshape(-1, 1, 1, F), 1, T,
                                   use_pallas=False))
    neg = idx < 0
    wrapped = np.zeros_like(got)
    np.add.at(wrapped, idx[neg] + T, upd[neg])
    np.testing.assert_allclose(xla - got, wrapped, rtol=1e-6, atol=1e-6)
    assert np.abs(wrapped[T - 5]).max() >= 100.0


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


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "rows_beyond_int32",
                                 "devices_differ", "no_kernel_for_device"])
def test_wrapper_rejects_bad_inputs(bad):
    idx = torch.zeros((4, 2, 8), dtype=torch.int32)
    upd = torch.zeros((4, 2, 8, 2))
    n_levels, T = 2, 16
    if bad == "dtype":
        idx = idx.long()
    elif bad == "shape":
        upd = upd[:, :1]
    elif bad == "contiguity":
        upd = torch.zeros((4, 2, 2, 8)).transpose(2, 3)
    elif bad == "rows_beyond_int32":
        n_levels, T = 2 ** 12, 2 ** 19
    elif bad == "devices_differ":
        upd = upd.to("meta")
    else:
        idx, upd = idx.to("meta"), upd.to("meta")
    with pytest.raises((TypeError, ValueError)):
        hash_scatter_add_per_level(idx, upd, n_levels, T)


def _per_level_inputs(rng, M, L, T, C, F=2):
    local = rng.integers(0, T, (M, L, C))
    idx = (local + np.arange(L)[None, :, None] * T).astype(np.int32)
    upd = (rng.standard_normal((M, L, C, F)) * 10).astype(np.float32)
    return idx, upd


@pytest.mark.parametrize("M,L,T,C", [
    (400, 4, 256, 8),       # every level's slab small enough for shared memory
    (401, 3, 3 * 1024, 8),  # an odd M and T
    (400, 4, 256, 1),       # one corner a level
])
def test_rows_outside_their_levels_slab_are_added(rng, M, L, T, C):
    """A level's entry may name a row of another level's slab: it is added
    there; only rows outside the whole table are dropped."""
    idx, upd = _per_level_inputs(rng, M, L, T, C)
    idx[::7, 1, 0] = idx[::7, L - 1, 0]         # level 1's entry in the last slab
    idx[::5, L - 1, -1] = idx[::5, 0, -1]       # and the last level's in slab 0
    idx[0, 0, :2] = L * T                       # padding, dropped
    want = np.asarray(jax_per_level(jnp.asarray(idx), jnp.asarray(upd), L, T,
                                    use_pallas=False))
    got = hash_scatter_add_per_level(torch.from_numpy(idx), torch.from_numpy(upd), L, T)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    foreign = np.zeros((L * T, 2), np.float64)
    np.add.at(foreign, idx[::7, 1, 0], upd[::7, 1, 0])
    assert np.abs(foreign).sum() > 0            # the case holds such rows


@pytest.mark.parametrize("payload_bf16", [False, True])
def test_one_corner_sections_match_jax(rng, payload_bf16):
    """The stochastic encode's shape: one corner a (sample, level)."""
    M, L, T = 3000, 8, 512
    idx, upd = _per_level_inputs(rng, M, L, T, 1)
    want = np.asarray(jax_per_level(jnp.asarray(idx), jnp.asarray(upd), L, T,
                                    use_pallas=False, payload_bf16=payload_bf16))
    got = hash_scatter_add_per_level(torch.from_numpy(idx), torch.from_numpy(upd), L, T,
                                     payload_bf16).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("F", [1, 4])
def test_other_feature_widths_match_jax(rng, F):
    """Widths other than the grid's 2; payload_bf16 is ignored there."""
    M, L, T = 300, 3, 128
    idx, upd = _per_level_inputs(rng, M, L, T, 8, F)
    want = np.asarray(jax_per_level(jnp.asarray(idx), jnp.asarray(upd), L, T,
                                    use_pallas=False, payload_bf16=True))
    got = hash_scatter_add_per_level(torch.from_numpy(idx), torch.from_numpy(upd), L, T,
                                     payload_bf16=True).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_no_updates_give_a_zero_table():
    idx = torch.zeros((0, 3, 8), dtype=torch.int32)
    got = hash_scatter_add_per_level(idx, torch.zeros((0, 3, 8, 2)), 3, 64)
    assert got.shape == (3 * 64, 2) and got.dtype == torch.float32
    assert not got.any()


@pytest.mark.parametrize("mode", ["exact", "hybrid"])
def test_encode_backward_gives_each_section_its_own_slabs(monkeypatch, mode):
    """The hash encode's backward calls the scatter once a section, with
    the section's levels, rows local to the section (level l of it in
    [l·T, (l+1)·T)) and 8 corners (exact) or 1 (stochastic) a level."""
    from stable_nerf_tpu_torch.config import HashGridConfig
    from stable_nerf_tpu_torch.ops import encoding

    cfg = HashGridConfig(n_levels=6, log2_hashmap_size=9, base_resolution=4)
    T = cfg.table_size
    calls = []

    def record(idx, upd, n_levels, table_size, payload_bf16=False):
        slabs = torch.arange(n_levels)[None, :, None]
        assert bool(((idx >= slabs * table_size) & (idx < (slabs + 1) * table_size)).all())
        calls.append((tuple(idx.shape), tuple(upd.shape), n_levels, table_size))
        return hash_scatter_add_per_level(idx, upd, n_levels, table_size, payload_bf16)

    monkeypatch.setattr(encoding, "hash_scatter_add_per_level", record)
    g = torch.Generator().manual_seed(0)
    table = torch.rand((cfg.n_levels * T, 2), generator=g).requires_grad_(True)
    x = torch.rand((50, 3), generator=g)
    encoding.hash_grid_encode({"table": table}, x, cfg, custom_bwd=True,
                              stochastic=mode == "hybrid",
                              stochastic_min_level=2).sum().backward()
    if mode == "exact":
        assert calls == [((50, 6, 8), (50, 6, 8, 2), 6, T)]
    else:
        assert calls == [((50, 2, 8), (50, 2, 8, 2), 2, T),
                         ((50, 4, 1), (50, 4, 1, 2), 4, T)]
    assert table.grad.shape == table.shape and float(table.grad.abs().sum()) > 0
