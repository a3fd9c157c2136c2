"""The port's sorted row gather (ops/hopper/gather.py, plain version on the
CPU) against the JAX package's Pallas kernel ``sorted_window_gather`` run
in interpret mode, and the sorted-encode floor script on the CPU.

Inputs come from a numpy seed and go to both packages.  The gather is
exact (``assert_array_equal``): it only rounds table values to bf16.  The
floor script's production lookup is held to 1e-6 against the JAX script's
``encode_xla`` (a weighted sum of 8 f32 rows in another order).
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_nerf_tpu.config import HashGridConfig as JHashGridConfig
from stable_nerf_tpu.ops import encoding as jenc
from stable_nerf_tpu.ops.pallas.gather import sorted_window_gather as jgather
from stable_nerf_tpu_torch.ops.hopper import gather as tgather

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _gather_inputs(case, rng):
    """The three cases of tests/test_pallas_v2_kernels.py::test_gather_*."""
    if case == "rows":
        T, idx = 8192, np.sort(rng.integers(0, 8192, 3000))
    elif case == "wide_span_multi_chunk":
        T, idx = 32768, np.sort((np.arange(1024) * 31) % 32768)
    else:
        T, idx = 8192, np.asarray([0, 0, 0, 1, 4095, 4096, 8191, 8191])
    return rng.standard_normal((T, 2)).astype(np.float32), idx.astype(np.int32)


@pytest.mark.parametrize("case", ["rows", "wide_span_multi_chunk",
                                  "duplicate_and_edge"])
def test_gather_matches_pallas_kernel(rng, case):
    table, idx = _gather_inputs(case, rng)
    want = np.asarray(jgather(jnp.asarray(table), jnp.asarray(idx), interpret=True))
    before = tgather.sorted_window_gather.launches
    got = tgather.sorted_window_gather(torch.from_numpy(table), torch.from_numpy(idx))
    # on the CPU the wrapper runs its plain version: no kernel launch
    assert tgather.sorted_window_gather.launches == before
    assert got.dtype == torch.float32 and got.shape == (idx.shape[0], 2)
    np.testing.assert_array_equal(got.numpy(), want)


def test_gather_out_of_range_negative_and_odd_length(rng):
    """Entries >= T read row T-1 and negative entries row 0, as the Pallas
    kernel clamps them; M is no multiple of its 1024-item window."""
    T = 4096
    table = rng.standard_normal((T, 2)).astype(np.float32)
    idx = np.concatenate([[-9, -1], np.sort(rng.integers(0, T, 1030)),
                          [T, T + 1, 2 ** 30]]).astype(np.int32)
    want = np.asarray(jgather(jnp.asarray(table), jnp.asarray(idx), interpret=True))
    got = tgather.sorted_window_gather(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    rounded = torch.from_numpy(table).to(torch.bfloat16).float()
    assert torch.equal(got[:2], rounded[[0, 0]]) and torch.equal(got[-3:],
                                                                 rounded[[-1] * 3])


@pytest.mark.parametrize("F", [1, 2, 4, 8])
def test_gather_bf16_table_unsorted_and_widths(rng, F):
    """A bf16 table is read as it is; unsorted indices give the same rows
    (the Pallas kernel needs them sorted, so the reference here is the
    indexing it is tested against)."""
    T = 4096
    table = rng.standard_normal((T, F)).astype(np.float32)
    idx = rng.integers(0, T, 777).astype(np.int32)
    ref = np.asarray(jnp.asarray(table).astype(jnp.bfloat16).astype(jnp.float32)[idx])
    for t in (torch.from_numpy(table), torch.from_numpy(table).to(torch.bfloat16)):
        got = tgather.sorted_window_gather(t, torch.from_numpy(idx))
        np.testing.assert_array_equal(got.numpy(), ref)
    empty = tgather.sorted_window_gather(torch.from_numpy(table),
                                         torch.zeros(0, dtype=torch.int32))
    assert empty.shape == (0, F) and empty.dtype == torch.float32


def test_gather_special_values_round_as_jax():
    """NaN, infinities, denormals and rounding ties go to bf16 as JAX's
    cast does (round to nearest even)."""
    vals = np.asarray([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-40, -1e-40,
                       1.17549435e-38, 3.4028235e38, 1.00390625, 1.01171875,
                       65504.0], np.float32)
    table = np.stack([vals, vals[::-1]], axis=1)
    idx = np.arange(len(vals), dtype=np.int32)
    want = np.asarray(jnp.asarray(table).astype(jnp.bfloat16).astype(jnp.float32))
    got = tgather.sorted_window_gather(torch.from_numpy(table.copy()),
                                       torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    keep = ~np.isnan(want)
    np.testing.assert_array_equal(got[keep].view(np.int32), want[keep].view(np.int32))


@pytest.mark.parametrize("bad", ["int64_index", "non_contiguous_table",
                                 "non_contiguous_index", "int_table", "rank"])
def test_gather_wrapper_rejects_what_the_kernel_does_not_take(bad):
    table = torch.zeros((16, 2))
    idx = torch.zeros(4, dtype=torch.int32)
    if bad == "int64_index":
        idx = idx.long()
    elif bad == "non_contiguous_table":
        table = torch.zeros((2, 16)).T
    elif bad == "non_contiguous_index":
        idx = torch.zeros(8, dtype=torch.int32)[::2]
    elif bad == "int_table":
        table = table.int()
    else:
        idx = idx[None]
    with pytest.raises((TypeError, ValueError)):
        tgather.sorted_window_gather(table, idx)


# -- the sorted-encode floor script ----------------------------------------

@pytest.fixture(scope="module")
def floor():
    path = os.path.join(REPO, "scripts", "bench_torch_fused_render_floor.py")
    spec = importlib.util.spec_from_file_location("bench_torch_floor", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_floor_measure_on_cpu(floor):
    """The four stages at M = 512 on the CPU: the path's own equality check
    passes (``measure`` raises otherwise) and every stage is timed."""
    r = floor.measure(512, "cpu", 0, reps=1)
    assert r["device"] == "cpu" and r["realigned_equal"]
    assert r["items"] == 512 * 16 * 8 and r["table_rows"] == 16 * 2 ** 19
    assert r["gather_launches"] == 0       # the plain version on the CPU
    for k in ("a_lookup_ms", "b_sort_ms", "c_gather_ms", "d_realign_ms"):
        assert r[k] > 0
    assert r["floor_ms"] == pytest.approx(r["b_sort_ms"] + r["c_gather_ms"]
                                          + r["d_realign_ms"])
    if not torch.cuda.is_available():      # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            floor.measure(512)


def test_floor_stages_match_jax_script(rng, floor):
    """Stage A against the JAX script's ``encode_xla`` (lines 99-106) on the
    same table and positions, within 1e-6; the sorted stages reproduce
    ``bf16(table)[flat_idx]`` exactly."""
    cfg = JHashGridConfig()
    L, T, F, C, M = cfg.n_levels, cfg.table_size, cfg.n_features_per_level, 8, 512
    table = rng.standard_normal((L * T, F)).astype(np.float32)
    x = rng.random((M, 3)).astype(np.float32)
    fi, w = jenc._indices_weights(jnp.asarray(x), cfg, False)
    jtable = jnp.asarray(table)
    tables = jtable.reshape(L, T, F)
    outs = []
    for lv in range(L):
        local = fi[:, lv, :] - lv * T
        feats = tables[lv][local.reshape(-1)].reshape(M, C, F)
        outs.append(jnp.sum(feats * w[:, lv], axis=1))
    want = np.asarray(jnp.concatenate(outs, axis=-1))

    from stable_nerf_tpu_torch.config import HashGridConfig
    from stable_nerf_tpu_torch.ops.encoding import _indices_weights_exact

    rows, cw = _indices_weights_exact(torch.from_numpy(x), HashGridConfig(), 0, L)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(fi))
    ttable = torch.from_numpy(table)
    got = floor.lookup(ttable, rows, cw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)

    idx_lm = rows.permute(1, 0, 2).reshape(L, M * C).to(torch.int32).contiguous()
    sidx, srank = floor.sort_levels(idx_lm)
    flat = sidx.reshape(-1)
    assert bool((flat[1:] >= flat[:-1]).all())      # globally sorted
    feats = tgather.sorted_window_gather(ttable, flat).reshape(L, M * C, F)
    back = floor.realign(feats, srank)
    ref = np.asarray(jtable.astype(jnp.bfloat16).astype(jnp.float32))[idx_lm.numpy()]
    np.testing.assert_array_equal(back.numpy(), ref)
