"""The port's occupancy-grid maintenance (models/nerf/grid.py) against the
JAX package's on the CPU, at grid 16 with bound 2 (two cascades).

``mark_untrained_grid``: the same poses (random orbits, and Blender-convention
captures through ``nerf_matrix_to_ngp``) and intrinsics; the −1 marks must
be equal.  The frustum test compares floats, so a cell exactly on a
frustum plane could flip with the order of the 3-term dot products:
``MAX_FLIPPED_CELLS`` (0) states how many may.

``update_extra_state``: the same state, the same NeRF (JAX weights through
``convert.params_from_jax``) and the random numbers JAX's key splits
produce, on both sides of the 16-refresh switch from the full sweep to the
partial one.  The EMA grid, ``mean_density`` and ``occ`` within 1e-6
relative (1e-6 absolute near 0), sigma being float32 MLP outputs summed in
other orders.  Where the partial sweep draws a cell twice, neither
framework fixes which draw is stored: with JAX's jitter those cells are
left out of the comparison; with zero jitter both draws agree and
everything is compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_nerf_tpu.config import HashGridConfig as JHashGridConfig
from stable_nerf_tpu.config import NeRFConfig as JNeRFConfig
from stable_nerf_tpu.data import rays as jrays
from stable_nerf_tpu.models.nerf import grid as jgrid
from stable_nerf_tpu.models.nerf import network as jnet
from stable_nerf_tpu_torch import convert
from stable_nerf_tpu_torch.data import rays as trays
from stable_nerf_tpu_torch.models.nerf import grid as tgrid
from stable_nerf_tpu_torch.models.nerf import network as tnet

torch.set_num_threads(2)
RTOL, ATOL = 1e-6, 1e-6
MAX_FLIPPED_CELLS = 0
H = 16


def _cfg():
    jc = JNeRFConfig(channel_dim=4, grid_size=H, bound=2.0,
                     encoding_sigma=JHashGridConfig(n_levels=4, log2_hashmap_size=10,
                                                    base_resolution=4))
    tc = convert.config_from_jax(jc)
    assert tc.cascade == jc.cascade == 2
    return jc, tc


def _blender_poses(n=12):
    """Orbit cameras looking at the origin along −z (Blender convention),
    through the loader's ngp conversion."""
    poses = []
    for i in range(n):
        th = 2 * np.pi * i / n
        c = 4.0 * np.array([np.sin(th), 0.3, np.cos(th)], np.float32)
        f = c / np.linalg.norm(c)
        x = np.cross([0.0, 1.0, 0.0], f)
        x /= np.linalg.norm(x)
        y = np.cross(f, x)
        p = np.eye(4, dtype=np.float32)
        p[:3, :3] = np.stack([x, y, f], -1)
        p[:3, 3] = c
        poses.append(trays.nerf_matrix_to_ngp(p))
    return np.stack(poses).astype(np.float32)


@pytest.mark.parametrize("poses_kind", ["rand_poses", "blender"])
def test_mark_untrained_grid_equals_jax(poses_kind):
    jc, tc = _cfg()
    if poses_kind == "rand_poses":
        poses = np.asarray(jrays.rand_poses(jax.random.PRNGKey(3), 6, radius=2.5))
    else:
        poses = _blender_poses()
    intr = (20.0, 20.0, 8.0, 8.0)
    state = jgrid.grid_init(jc)
    want = np.asarray(jgrid.mark_untrained_grid(state, jnp.asarray(poses), intr, jc)
                      .density_grid)
    got = tgrid.mark_untrained_grid(tgrid.grid_init(tc, device="cpu"),
                                    torch.tensor(poses), intr, tc).density_grid.numpy()
    assert int(np.sum(got != want)) <= MAX_FLIPPED_CELLS
    trained = float(np.mean(got >= 0))
    assert 0.0 < trained < 1.0, trained      # cameras see part of the grid
    assert set(np.unique(got)) <= {-1.0, 0.0}


def test_reset_extra_state_clears_the_marks():
    jc, tc = _cfg()
    s = tgrid.mark_untrained_grid(tgrid.grid_init(tc, device="cpu"),
                                  torch.from_numpy(_blender_poses()), (20, 20, 8, 8), tc)
    assert bool((s.density_grid < 0).any())
    r = tgrid.reset_extra_state(tc, device="cpu")
    ref = jgrid.reset_extra_state(jc)
    for a, b in zip(r, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _jax_draws(key, jc, partial):
    """The numbers update_extra_state draws from ``key`` (grid.py:148, 155,
    163-181, 187), per cascade."""
    H3, C = jc.grid_size ** 3, jc.cascade
    k_branch, _ = jax.random.split(key)
    if not partial:
        keys = jax.random.split(k_branch, C)
        return {"noise": [np.asarray(jax.random.uniform(keys[c], (H3, 3), minval=-1.0,
                                                        maxval=1.0)) for c in range(C)]}
    N = H3 // 4
    keys = jax.random.split(k_branch, 3 * C).reshape(C, 3, 2)
    out = {"noise": [], "rand_idx": [], "u": [], "fallback_idx": []}
    for c in range(C):
        k_rand, k_occ, k_noise = keys[c]
        out["rand_idx"].append(np.asarray(jax.random.randint(k_rand, (N,), 0, H3)))
        out["u"].append(np.asarray(jax.random.uniform(k_occ, (N,))))
        out["fallback_idx"].append(np.asarray(jax.random.randint(k_occ, (N,), 0, H3)))
        out["noise"].append(np.asarray(jax.random.uniform(k_noise, (2 * N, 3),
                                                          minval=-1.0, maxval=1.0)))
    return out


def _state(jc, iter_density, rng):
    """A grid with untrained cells, empty cells and densities around the
    threshold; cascade 1 has no occupied cell (the partial sweep's
    fallback)."""
    C, H3 = jc.cascade, jc.grid_size ** 3
    grid = rng.uniform(0.0, 0.05, (C, H3)).astype(np.float32)
    grid[rng.uniform(size=(C, H3)) < 0.2] = -1.0
    grid[1] = np.minimum(grid[1], 0.0)
    occ = (grid > 0.01).reshape(C, H, H, H)
    return (grid, occ, np.float32(np.clip(grid, 0, None).mean()), np.int32(iter_density))


@pytest.mark.parametrize("iter_density,jitter", [(15, "jax"), (16, "jax"), (16, "zero")])
def test_update_extra_state_equals_jax(iter_density, jitter):
    jc, tc = _cfg()
    rng = np.random.default_rng(iter_density)
    jparams = jnet.nerf_init(jax.random.PRNGKey(1), jc)
    # a wider table so that densities are far from 0 and cross the threshold
    jparams = jparams._replace(hash=jparams.hash._replace(table=jparams.hash.table * 300.0))
    tparams = convert.params_from_jax(jparams)
    grid, occ, mean, it = _state(jc, iter_density, rng)
    partial = iter_density >= 16
    key = jax.random.PRNGKey(7)
    draws = _jax_draws(key, jc, partial)

    if jitter == "zero":
        # JAX's refresh draws its jitter from its key; a zero jitter is
        # given to JAX's own arithmetic and NeRF instead
        draws["noise"] = [np.zeros_like(n) for n in draws["noise"]]
        want = _jax_update_with_draws(jc, jparams, (grid, occ, mean, it), draws)
    else:
        state = jgrid.OccupancyGridState(*(jnp.asarray(a) for a in (grid, occ, mean, it)))
        want = jgrid.update_extra_state(
            state, lambda x: jnet.nerf_density(jparams, x, jc)["sigma"], key, jc)
        want = [np.asarray(a) for a in want]

    tstate = tgrid.OccupancyGridState(*(torch.from_numpy(np.array(a)) for a in
                                        (grid, occ, mean, it)))
    got = tgrid.update_extra_state(
        tstate, lambda x: tnet.nerf_density(tparams, x, tc)["sigma"], tc,
        draws={k: [torch.from_numpy(np.asarray(a)) for a in v] for k, v in draws.items()})
    got = [a.numpy() for a in got]

    keep = np.ones(grid.shape, bool)
    if partial and jitter == "jax":
        for c in range(jc.cascade):
            idx = np.concatenate([draws["rand_idx"][c], _occ_idx(grid[c], draws, c)])
            counts = np.bincount(idx, minlength=grid.shape[1])
            keep[c] = counts <= 1
        assert keep.mean() > 0.5
    np.testing.assert_allclose(got[0][keep], want[0][keep], rtol=RTOL, atol=ATOL)
    changed = np.abs(want[0] - grid) > 0
    assert changed[keep].mean() > 0.2                  # the refresh did something
    np.testing.assert_array_equal(got[1].reshape(grid.shape)[keep],
                                  want[1].reshape(grid.shape)[keep])
    if keep.all():
        np.testing.assert_allclose(got[2], want[2], rtol=RTOL, atol=ATOL)
    assert int(got[3]) == int(want[3]) == iter_density + 1


def _occ_idx(grid_c, draws, c):
    """The partial sweep's draws among the occupied cells (grid.py:168-181),
    in numpy."""
    H3 = grid_c.shape[0]
    cnt = np.cumsum(grid_c > 0).astype(np.int32)
    total = cnt[-1]
    if total == 0:
        return np.asarray(draws["fallback_idx"][c])
    r = np.floor(np.asarray(draws["u"][c], np.float32) * np.float32(total)).astype(np.int32)
    return np.minimum(np.searchsorted(cnt, r, side="right"), H3 - 1)


def _jax_update_with_draws(jc, jparams, state, draws, decay=0.95):
    """JAX's update_extra_state arithmetic (grid.py:183-206) on given
    draws, with JAX's own nerf_density and numpy indexing: the reference
    for the zero-jitter case, where JAX's key-drawn jitter would move the
    points."""
    grid, _, _, it = state
    H3, C = jc.grid_size ** 3, jc.cascade
    coords = np.asarray(jgrid._cell_coords(jc.grid_size))
    tmp = -np.ones((C, H3), np.float32)
    for c in range(C):
        bound, hgs = jgrid._cascade_bounds(jc, c)
        if it < 16:
            idx = np.arange(H3)
        else:
            idx = np.concatenate([draws["rand_idx"][c], _occ_idx(grid[c], draws, c)])
        xyz = (2.0 * coords[idx].astype(np.float32) / (jc.grid_size - 1) - 1.0) \
            * np.float32(bound - hgs) + draws["noise"][c] * np.float32(hgs)
        tmp[c, idx] = np.asarray(jnet.nerf_density(jparams, jnp.asarray(xyz), jc)["sigma"])
    valid = (grid >= 0) & (tmp >= 0)
    new = np.where(valid, np.maximum(grid * np.float32(decay), tmp), grid)
    mean = np.float32(np.clip(new, 0, None).mean())
    occ = new > min(mean, np.float32(jc.density_thresh))
    return [new, occ.reshape(C, jc.grid_size, jc.grid_size, jc.grid_size), mean,
            np.int32(it + 1)]
