"""The host side of the hash-encode kernel (ops/hopper/encode.py), on the CPU.

The level table that ``hash_grid_encode`` passes the kernel is checked
against the plain functions it replaces on the card: its fields against
``_level_geometry`` and ``_sections``, and a model of the kernel's uint32
arithmetic in Python integers and numpy float32 scalars, fed only the
table, against the plain rows and ``_stateless_uniform3``'s draws.  Then
the dispatch rule as a function of what a call can observe, and a CPU
encode that touches no kernel counter.  This file imports neither JAX nor
the JAX package.
"""

import numpy as np
import pytest
import torch

from stable_nerf_tpu_torch.config import HashGridConfig
from stable_nerf_tpu_torch.ops import encoding
from stable_nerf_tpu_torch.ops.hopper.encode import (hash_encode_backward,
                                                     hash_encode_forward)
from stable_nerf_tpu_torch.ops.hopper.scatter import hash_scatter_add_per_level
from stable_nerf_tpu_torch.utils import profiling

GRIDS = {
    "flagship": HashGridConfig(),
    "train_tiny": HashGridConfig(n_levels=4, log2_hashmap_size=12, base_resolution=4),
    "card_test": HashGridConfig(n_levels=6, log2_hashmap_size=12, base_resolution=4),
}
MODES = {"exact": (False, 0), "stochastic": (True, 0), "hybrid": (True, 3)}
MASK = 0xFFFFFFFF
PRIMES = (1, 2654435761, 805459861)


def _positions(n, seed=0):
    x = np.random.default_rng(seed).uniform(0, 1, (n, 3)).astype(np.float32)
    x[:6] = [[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [-0.25, 0.5, 1.75],
             [1.5, -0.5, 0.5], [0.999999, 1e-7, 0.5]]
    return x


def _mix(v, c):
    v = ((v ^ (v >> 16)) * c) & MASK
    v = ((v ^ (v >> 13)) * 0x5BD1E995) & MASK
    return v ^ (v >> 16)


def _model_level(x, p, T):
    """The kernel's rows of one sample at one level, from the table row
    ``p`` alone: 8 corners, or the one corner drawn."""
    pos = [np.float32(np.float32(v) * np.float32(p.scale)) + np.float32(0.5) for v in x]
    fl = [np.floor(v) for v in pos]
    w = [np.float32(a - b) for a, b in zip(pos, fl)]
    c0 = [int(v) & MASK for v in fl]

    def row(cx, cy, cz):
        cx, cy, cz = cx & MASK, cy & MASK, cz & MASK
        r = p.resolution
        v = ((cx + cy * r + cz * r * r) if p.dense
             else (cx * PRIMES[0]) ^ (cy * PRIMES[1]) ^ (cz * PRIMES[2])) & MASK
        return v % T + p.offset

    if not p.one_corner:
        return [row(c0[0] + i, c0[1] + j, c0[2] + k)
                for i in (0, 1) for j in (0, 1) for k in (0, 1)]
    b = [int(np.float32(v).view(np.uint32)) for v in x]
    hh = ((b[0] * PRIMES[0]) ^ (b[1] * PRIMES[1]) ^ (b[2] * PRIMES[2])) & MASK ^ p.salt
    bits = [np.float32(_mix(hh, c) >> 8) * np.float32(2.0 ** -24) < wa
            for c, wa in zip((0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F), w)]
    return [row(c0[0] + int(bits[0]), c0[1] + int(bits[1]), c0[2] + int(bits[2]))]


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_level_table_equals_the_plain_geometry_and_draw(grid, mode):
    cfg = GRIDS[grid]
    stochastic, min_level = MODES[mode]
    L, T = cfg.n_levels, cfg.table_size
    levels = encoding.level_table(cfg, stochastic, min_level)
    assert len(levels) == L
    assert encoding.level_table(cfg, stochastic, min_level) is levels      # built once
    scales, resolutions, dense = encoding._level_geometry(cfg)
    f32 = torch.tensor(scales, dtype=torch.float32)
    one = {l: o for lv0, lv1, o in encoding._sections(L, stochastic, min_level)
           for l in range(lv0, lv1)}
    for l, p in enumerate(levels):
        assert p.scale == float(f32[l])
        assert (p.resolution, bool(p.dense), p.offset) == (resolutions[l], dense[l], l * T)
        assert bool(p.one_corner) == one[l]

    x = _positions(200)
    sections = encoding._hash_sections(torch.from_numpy(x), cfg, stochastic, min_level)
    for m in range(x.shape[0]):
        model = [_model_level(x[m], levels[l], T) for l in range(L)]
        for lv0, rows, _ in sections:
            for s in range(rows.shape[1]):
                assert rows[m, s].tolist() == model[lv0 + s]

    # the salts: the model's uniforms equal _stateless_uniform3's
    u = encoding._stateless_uniform3(torch.from_numpy(x[:20]), L, 0).numpy()
    for m in range(20):
        b = [int(v) for v in x[m].view(np.uint32)]
        h = ((b[0] * PRIMES[0]) ^ (b[1] * PRIMES[1]) ^ (b[2] * PRIMES[2])) & MASK
        for l, p in enumerate(levels):
            got = [np.float32(_mix(h ^ p.salt, c) >> 8) * np.float32(2.0 ** -24)
                   for c in (0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F)]
            assert np.array_equal(np.asarray(got, np.float32), u[m, l])


@pytest.mark.parametrize("device_type", ["cpu", "cuda"])
@pytest.mark.parametrize("custom_bwd", [False, True])
@pytest.mark.parametrize("grad_wanted", [False, True])
def test_dispatch_rule(device_type, custom_bwd, grad_wanted):
    want = device_type == "cuda" and (custom_bwd or not grad_wanted)
    assert encoding._use_kernel(device_type, custom_bwd, grad_wanted) is want


def test_cpu_encode_touches_no_kernel_counter():
    cfg = GRIDS["card_test"]
    g = torch.Generator().manual_seed(0)
    table = (torch.rand((cfg.n_levels * cfg.table_size, 2), generator=g) - 0.5)
    x = torch.rand((300, 3), generator=g)
    launches = (hash_encode_forward.launches, hash_encode_backward.launches,
                hash_scatter_add_per_level.launches)
    profiling.reset_spans()
    with profiling.tracing():
        for custom_bwd, stochastic in ((True, False), (True, True), (False, False)):
            t = table.clone().requires_grad_(True)
            encoding.hash_grid_encode({"table": t}, x, cfg, custom_bwd=custom_bwd,
                                      stochastic=stochastic,
                                      stochastic_min_level=3).sum().backward()
            assert t.grad is not None and float(t.grad.abs().sum()) > 0
        with torch.no_grad():
            encoding.hash_grid_encode({"table": table}, x.reshape(3, 100, 3), cfg)
        got = profiling.counters()
    profiling.reset_spans()
    assert got.get("nerf.encode_samples") == 4 * 300
    assert "nerf.encode_kernel_samples" not in got
    assert (hash_encode_forward.launches, hash_encode_backward.launches,
            hash_scatter_add_per_level.launches) == launches


def test_wrappers_take_no_cpu_tensor():
    cfg = GRIDS["train_tiny"]
    levels = encoding.level_table(cfg)
    x = torch.rand((10, 3))
    table = torch.zeros((cfg.n_levels * cfg.table_size, 2))
    with pytest.raises(ValueError, match="CUDA"):
        hash_encode_forward(x, table, levels, cfg.table_size)
    with pytest.raises(ValueError, match="CUDA"):
        hash_encode_backward(x, torch.zeros((10, cfg.output_dim)), levels, 0,
                             cfg.n_levels, cfg.table_size)
