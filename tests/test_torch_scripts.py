"""The port's study and tool scripts on the CPU, against the JAX package's
scripts and functions on the same inputs (numpy from a seed).

* bench_torch_scatter_variants: ``--check``'s kernel results against the
  Pallas K1 (``sorted_block_scatter_add_v2``) in interpret mode and, for
  K2 (``sorted_block_scatter_add``, which has no interpret mode), against
  the XLA route its caller takes off a TPU (``hash_scatter_add(...,
  use_pallas=False)``), as tests/test_torch_scatter.py runs them, within
  1e-5 of the largest magnitude (float32 sums in other orders; K1's
  hi/lo split accumulates ~1e-5 relative);
  ``pack_bf16_pair`` bit for bit against
  JAX's, and its inverse; the batched sorts' keys equal and their scatter
  results equal (``torch.sort`` and ``lax.sort`` may order equal keys
  differently, so payload order is not compared).
* bench_torch_step_ablation / bench_torch_eval_ablation: each stage's
  outputs at a tiny NeRF (4 levels × 2^12, grid 32) against the same
  composition of JAX package functions, with JAX's draws, rays and grid
  injected.  The march and the stochastic encode run JAX eagerly (XLA's
  jit fuses ``o + t·d`` into a multiply-add, an ulp away, and the
  stochastic encode hashes a position's bits); the exact-encode stages
  run jitted.  float32 values within 1e-5 relative; bf16 chains
  within 2e-2 of the largest magnitude (bf16 rounding), as
  tests/test_torch_nerf.py holds them.
* bench_torch_encode_split / bench_torch_table_dtype: the flat and the
  per-level encodes equal each other and JAX's within 1e-6 relative; the
  bf16 cast and the packed table bit for bit; the packed encodes within
  1e-6 relative of JAX's.
* bench_torch_gather_by_table: the 8-corner form within 1e-6 of JAX's
  largest magnitude (float32 sums of 8 in another order).
* bench_torch_unet_layout: the NCHW chain equals the channels-last chain
  and both JAX's NCHW chain at c = 8 within 2e-2 of the largest magnitude
  (bf16); SDPA f32 and bf16 within 2e-2 of JAX's.
* Each study script's ``run`` at a tiny size on the CPU: every row present
  and finite (no time is checked here).
* bench_torch_grid_refresh at ``--grid 16 --device cpu``.
* make_torch_sdxl_key_manifest: byte for byte the committed fixtures.
* make_torch_synthetic_scene: at ``--n-views 4 --size 16`` equal to the
  JAX script's output (no pixel may differ: both trace the same rays in
  float64); at its defaults against the committed
  datasets/nerf/synthetic_spheres.npz, which today's JAX script does not
  reproduce either: 65,188 of its 1,048,576 pixels differ, the same for
  both scripts.
* weights_torch_drill_full_size: at tiny configurations (the templates,
  loader and exporters patched to them), ``bit_identical`` and
  the JAX drill's JSON keys.
"""

import dataclasses
import json
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_nerf_tpu.config import HashGridConfig as JHashGridConfig
from stable_nerf_tpu.config import NeRFConfig as JNeRFConfig
from stable_nerf_tpu.models.nerf import grid as jgrid
from stable_nerf_tpu.models.nerf import network as jnet
from stable_nerf_tpu.models.nerf import renderer as jrender
from stable_nerf_tpu.ops import compaction as jcomp
from stable_nerf_tpu.ops import encoding as jenc
from stable_nerf_tpu.ops.marching import march_rays_lattice as jmarch
from stable_nerf_tpu.ops.pallas.scatter import pack_bf16_pair as jpack_pair
from stable_nerf_tpu.ops.pallas.scatter import hash_scatter_add as jhash_scatter_add
from stable_nerf_tpu.ops.pallas.scatter_v2 import sorted_block_scatter_add_v2
from stable_nerf_tpu.ops.ray_ops import near_far_from_aabb as jnear_far
from stable_nerf_tpu_torch import convert
from stable_nerf_tpu_torch.utils.tree import tree_leaves
from test_torch_sd_scripts import _script

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
RTOL, ATOL = 1e-5, 1e-6
BF16_TOL = 2e-2
STUDIES = ("bench_torch_scatter_variants", "bench_torch_step_ablation",
           "bench_torch_eval_ablation", "bench_torch_encode_split", "bench_torch_table_dtype",
           "bench_torch_gather_by_table", "bench_torch_unet_layout",
           "bench_torch_grid_refresh")


@pytest.fixture(scope="module")
def scripts():
    return {name: _script(name) for name in STUDIES + (
        "make_torch_sdxl_key_manifest", "make_torch_synthetic_scene",
        "weights_torch_drill_full_size")}


def _t(x):
    return torch.from_numpy(np.array(x))


def _scale_close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-6)


# -- scatter variants ------------------------------------------------------------


def test_scatter_check_case_equals_the_pallas_kernels(scripts):
    sv = scripts["bench_torch_scatter_variants"]
    rng = np.random.default_rng(0)
    M, T = sv.CHECK_M, sv.CHECK_T
    idx = rng.integers(0, T, M).astype(np.int32)
    upd = rng.standard_normal((M, 2)).astype(np.float32)
    got = sv.check_case(_t(idx), _t(upd), T)
    order = np.argsort(idx, kind="stable")
    sidx, supd = jnp.asarray(idx[order]), jnp.asarray(upd[order])
    want = {"v1": jhash_scatter_add(jnp.asarray(idx), jnp.asarray(upd), T, use_pallas=False),
            "v2": sorted_block_scatter_add_v2(sidx, supd, T, interpret=True)}
    ref = np.zeros((T, 2), np.float64)
    np.add.at(ref, idx, upd)
    np.testing.assert_allclose(got["ref"].numpy(), ref, rtol=1e-4, atol=1e-5)
    for name in ("v1", "v2"):
        _scale_close(got[name].numpy(), want[name], 1e-5)
        assert sv.rel_err(got[name], got["ref"]) <= 1e-5


def test_pack_bf16_pair_is_jax_bit_for_bit(scripts):
    sv = scripts["bench_torch_scatter_variants"]
    rng = np.random.default_rng(1)
    upd = rng.standard_normal((3, 257, 2)).astype(np.float32) * 10.0 ** rng.integers(
        -30, 30, (3, 257, 2))
    upd[0, :4] = [[0.0, -0.0], [np.inf, -np.inf], [1e-40, -1e-40], [65504.0, 3.0e38]]
    got = sv.pack_bf16_pair(_t(upd)).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, np.asarray(jpack_pair(jnp.asarray(upd))))
    back = sv.unpack_bf16_pair(sv.pack_bf16_pair(_t(upd)))
    np.testing.assert_array_equal(back.numpy(),
                                  _t(upd).to(torch.bfloat16).float().numpy())


def test_batched_sorts_keep_keys_and_sums(scripts):
    """The batched and packed sorts' keys equal ``lax.sort``'s, and
    scattering their payloads gives the unsorted scatter's sums."""
    sv = scripts["bench_torch_scatter_variants"]
    rng = np.random.default_rng(2)
    L, M, T = 16, 16 * 300, 512
    idx = rng.integers(0, T, M).astype(np.int32)
    upd = rng.standard_normal((M, 2)).astype(np.float32)
    keys = np.asarray(jax.lax.sort(jnp.asarray(idx.reshape(L, -1)), dimension=1))
    for fn, round_bf16 in ((sv.sort_batched, False), (sv.sort_batched_packed, True)):
        si, su = fn(_t(idx), _t(upd))
        np.testing.assert_array_equal(si.numpy(), keys)
        u = _t(upd).to(torch.bfloat16).float() if round_bf16 else _t(upd)
        want = sv.scatter_index_add(_t(idx), u, T)
        got = sv.scatter_index_add(si.reshape(-1), su.reshape(-1, 2), T)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


# -- the NeRF ablations ---------------------------------------------------------


def _tiny_nerf(**kw):
    jc = JNeRFConfig(channel_dim=4, grid_size=32,
                     encoding_sigma=JHashGridConfig(n_levels=4, log2_hashmap_size=12,
                                                    base_resolution=4), **kw)
    return jc, convert.config_from_jax(jc)


@pytest.fixture(scope="module")
def nerf_case():
    """Tiny NeRF weights (the port's init, the table widened to ±0.5 so
    densities matter) in both layouts, 2 poses × 8² rays from JAX's
    ``get_rays``, JAX's per-ray jitter and a random 40% occupancy grid."""
    from stable_nerf_tpu.data.rays import get_rays as jget_rays
    from stable_nerf_tpu.data.rays import rand_poses as jrand_poses
    from stable_nerf_tpu_torch.models.nerf.network import nerf_init

    jcfg, tcfg = _tiny_nerf()
    tp = nerf_init(0, tcfg, device="cpu")
    tp["hash"]["table"].mul_(5e3)
    like = jax.eval_shape(lambda: jnet.nerf_init(jax.random.PRNGKey(0), jcfg))
    jp = jax.tree.map(jnp.asarray, convert.params_to_jax(tp, like=like))
    key = jax.random.PRNGKey(4)
    rays = jget_rays(jrand_poses(key, 2, radius=2.0), (138.0, 138.0, 32, 32), 8, 8)
    o = np.asarray(rays["rays_o"]).reshape(-1, 3)
    d = np.asarray(rays["rays_d"]).reshape(-1, 3)
    noise = np.asarray(jax.random.uniform(jax.random.fold_in(key, 1), (o.shape[0],)))
    occ = np.random.default_rng(5).random((tcfg.cascade,) + (32,) * 3) < 0.4
    return jcfg, tcfg, tp, jp, o, d, noise, occ


def _grids(jcfg, tcfg, occ):
    from stable_nerf_tpu_torch.models.nerf.grid import grid_init

    jg = jgrid.grid_init(jcfg)._replace(occ=jnp.asarray(occ))
    tg = grid_init(tcfg, device="cpu")._replace(occ=_t(occ))
    return jg, tg


def _jax_march(jcfg, occ, o, d, noise, max_steps):
    b = jcfg.bound
    aabb = jnp.asarray([-b, -b, -b, b, b, b], jnp.float32)
    nears, fars = jnear_far(jnp.asarray(o), jnp.asarray(d), aabb, jcfg.min_near)
    return jmarch(jnp.asarray(o), jnp.asarray(d), nears, fars, jnp.asarray(occ),
                  bound=jcfg.bound, cascade=jcfg.cascade, grid_size=jcfg.grid_size,
                  max_steps=max_steps, noise=None if noise is None else jnp.asarray(noise))


def test_step_ablation_march_and_compact_equal_jax(scripts, nerf_case):
    sa = scripts["bench_torch_step_ablation"]
    jcfg, tcfg, tp, jp, o, d, noise, occ = nerf_case
    budget = 256
    pos, valid = sa.stage_march(tcfg, _t(occ), _t(o), _t(d), _t(noise))
    jpos, _, _, jvalid, _ = _jax_march(jcfg, occ, o, d, noise, sa.MAX_STEPS)
    np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    pos_c, kept = sa.stage_compact(tcfg, _t(occ), _t(o), _t(d), _t(noise), budget)
    plan = jcomp.compact_plan(jvalid, budget)
    np.testing.assert_allclose(pos_c.numpy(), np.asarray(jcomp.gather_compact(plan, jpos)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(kept.numpy(), np.asarray(plan.new_valid))


def test_step_ablation_mlps_on_the_stand_in_encode_equal_jax(scripts, nerf_case):
    sa = scripts["bench_torch_step_ablation"]
    jcfg, tcfg, tp, jp, o, d, noise, occ = nerf_case
    budget = 256
    sigma, color = sa.stage_mlp_nohash(tp, tcfg, _t(occ), _t(o), _t(d), _t(noise), budget)
    jpos, _, _, jvalid, _ = _jax_march(jcfg, occ, o, d, noise, sa.MAX_STEPS)
    pos_c = jcomp.gather_compact(jcomp.compact_plan(jvalid, budget), jpos)
    width = jcfg.encoding_sigma.output_dim
    h = jnp.tile(pos_c, (1, -(-width // 3)))[:, :width].astype(jnp.bfloat16)
    h = jnet._mlp_apply(jp.sigma_mlp, h, jnp.bfloat16)
    jsigma = jax.nn.relu(h[..., 0]).astype(jnp.float32)
    jcolor = jnet.nerf_color(jp, jnp.zeros_like(pos_c), h[..., 1:], jcfg, jnp.bfloat16)
    _scale_close(sigma.numpy(), jsigma, BF16_TOL)
    _scale_close(color.numpy(), jcolor, BF16_TOL)


@pytest.mark.parametrize("stochastic", [False, True], ids=["exact", "stochastic"])
def test_step_ablation_full_forward_and_backward_equal_jax(scripts, nerf_case, stochastic):
    """The loss and its gradient in bf16 with the budget, JAX run eagerly
    with the same jitter (a render's ``perturb_key`` draws it)."""
    sa = scripts["bench_torch_step_ablation"]
    jcfg, tcfg, tp, jp, o, d, noise, occ = nerf_case
    jcfg = dataclasses.replace(jcfg, hash_stochastic=stochastic)
    tcfg = dataclasses.replace(tcfg, hash_stochastic=stochastic)
    budget = 256
    jg, tg = _grids(jcfg, tcfg, occ)
    key = jax.random.PRNGKey(7)
    jnoise = np.asarray(jax.random.uniform(key, (o.shape[0],)))

    def jloss(p):
        out = jrender.render(p, jg, jnp.asarray(o), jnp.asarray(d), jcfg, bg_color=1.0,
                             max_steps=sa.MAX_STEPS, perturb_key=key,
                             compute_dtype=jnp.bfloat16, sample_budget=budget)
        return jnp.mean(jnp.abs(out["image"] - 0.5))

    # the stochastic encode hashes a position's bits: run JAX eagerly there
    # (the exact encode's weights move by an ulp at most under jit)
    if stochastic:
        with jax.disable_jit():
            want_loss, want_grad = jax.value_and_grad(jloss)(jp)
    else:
        want_loss, want_grad = jax.jit(jax.value_and_grad(jloss))(jp)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jp), like=tp)
    loss = sa.full_loss(params, tcfg, tg, _t(o), _t(d), _t(jnoise), budget)
    grads = sa.full_grad(params, tcfg, tg, _t(o), _t(d), _t(jnoise), budget)
    assert abs(float(loss) - float(want_loss)) <= BF16_TOL * abs(float(want_loss))
    want_leaves = tree_leaves(convert.params_from_jax(jax.tree.map(np.asarray, want_grad),
                                                      like=tp))
    for g, w in zip(grads, want_leaves):
        _scale_close(g.numpy(), w.numpy(), BF16_TOL)


def test_eval_ablation_stages_equal_jax(scripts, nerf_case):
    """march512, +compact, +eval, +scatter_back and the full render on one
    grid, the port's against JAX's composition of the same functions."""
    ea = scripts["bench_torch_eval_ablation"]
    jcfg, tcfg, tp, jp, o, d, _, occ = nerf_case
    budget = 1024
    jg, tg = _grids(jcfg, tcfg, occ)
    # the march eagerly (positions to the ulp, the mask exactly), the
    # exact-encode stages after it jitted
    with jax.disable_jit():
        jpos, _, _, jvalid, _ = _jax_march(jcfg, occ, o, d, None, ea.MAX_STEPS)
    N, K = jvalid.shape
    plan = jcomp.compact_plan(jvalid, budget)
    ray_of = jnp.minimum(plan.src_idx // K, N - 1)
    jdirs = jnp.asarray(d)[ray_of] * plan.slot_used[:, None].astype(jnp.float32)
    jpos_c = jcomp.gather_compact(plan, jpos)
    jsig_c, jrgb_c = jax.jit(lambda p, x, v: jrender._eval_samples(
        p, x, v, jcfg, jnp.bfloat16, ea.EVAL_CHUNK))(jp, jpos_c, jdirs)
    jsig = jcomp.scatter_back(plan, jsig_c, N * K).reshape(N, K)
    jrgb = jcomp.scatter_back(plan, jrgb_c, N * K).reshape(N, K, jcfg.channel_dim)
    jfull = jax.jit(lambda p: jrender.render(
        p, jg, jnp.asarray(o), jnp.asarray(d), jcfg, bg_color=1.0, max_steps=ea.MAX_STEPS,
        compute_dtype=jnp.bfloat16, sample_budget=budget))(jp)
    occ_t, o_t, d_t = _t(occ), _t(o), _t(d)
    with torch.no_grad():
        pos, valid = ea.stage_march(tcfg, occ_t, o_t, d_t)
        pos_c, dirs_c, _ = ea.stage_compact(tcfg, occ_t, o_t, d_t, budget)
        sig_c, rgb_c = ea.stage_eval(tp, tcfg, occ_t, o_t, d_t, budget)
        sig, rgb = ea.stage_scatter_back(tp, tcfg, occ_t, o_t, d_t, budget)
        full = ea.full_render(tp, tcfg, tg, o_t, d_t, budget)
    np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(pos_c.numpy(), np.asarray(jpos_c), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dirs_c.numpy(), np.asarray(jdirs), rtol=RTOL, atol=ATOL)
    for got, want in ((sig_c, jsig_c), (rgb_c, jrgb_c), (sig, jsig), (rgb, jrgb)):
        _scale_close(got.numpy(), want, BF16_TOL)
    for k in ("image", "depth", "weights_sum"):
        _scale_close(full[k].numpy(), jfull[k], BF16_TOL)


# -- encode split, table dtype, gather by table -----------------------------------


@pytest.fixture(scope="module")
def encode_case():
    """A 4-level 2^12 table, 3,000 positions and their exact rows and
    weights (the port's, equal to JAX's: tests/test_torch_ops.py)."""
    from stable_nerf_tpu_torch.ops.encoding import _indices_weights_exact

    cfg = convert.config_from_jax(JHashGridConfig(n_levels=4, log2_hashmap_size=12,
                                                  base_resolution=4))
    jcfg = JHashGridConfig(n_levels=4, log2_hashmap_size=12, base_resolution=4)
    rng = np.random.default_rng(6)
    table = rng.uniform(-1, 1, (cfg.n_levels * cfg.table_size, 2)).astype(np.float32)
    x = rng.random((3000, 3)).astype(np.float32)
    rows, cw = _indices_weights_exact(_t(x), cfg, 0, cfg.n_levels)
    return cfg, jcfg, table, x, rows, cw


def test_encode_split_equals_flat_and_jax(scripts, encode_case):
    es = scripts["bench_torch_encode_split"]
    jes = _script("bench_encode_split")
    cfg, jcfg, table, x, rows, cw = encode_case
    jrows, jcw = jenc._indices_weights(jnp.asarray(x), jcfg, False)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    flat = es.encode_flat(_t(table), rows, cw, cfg).numpy()
    split = es.encode_split(_t(table), rows, cw, cfg).numpy()
    np.testing.assert_allclose(split, flat, rtol=1e-6, atol=1e-7)
    want = np.asarray(jes.encode_flat(jnp.asarray(table), jrows, jcw, jcfg))
    np.testing.assert_allclose(flat, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(split, np.asarray(jes.encode_split(jnp.asarray(table), jrows,
                                                                  jcw, jcfg)),
                               rtol=1e-6, atol=1e-7)
    full = jenc.hash_grid_encode(jenc.HashGridParams(table=jnp.asarray(table)),
                                 jnp.asarray(x), jcfg)
    np.testing.assert_allclose(flat, np.asarray(full), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("stochastic", [False, True], ids=["exact", "stochastic"])
def test_table_dtype_encodes_equal_jax(scripts, encode_case, stochastic):
    td = scripts["bench_torch_table_dtype"]
    jtd = _script("bench_table_dtype")
    cfg, jcfg, table, x, _, _ = encode_case
    from stable_nerf_tpu_torch.ops.encoding import (_indices_weights_exact,
                                                    _indices_weights_stochastic)

    iw = _indices_weights_stochastic if stochastic else _indices_weights_exact
    rows, cw = iw(_t(x), cfg, 0, cfg.n_levels)
    jrows, jcw = jenc._indices_weights(jnp.asarray(x), jcfg, stochastic)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    # the cast and the pack, bit for bit
    bf16 = _t(table).to(torch.bfloat16)
    jbf16 = jnp.asarray(table).astype(jnp.bfloat16)
    np.testing.assert_array_equal(bf16.view(torch.int16).numpy(),
                                  np.asarray(jbf16).view(np.int16))
    packed = td.pack_bf16(_t(table))
    np.testing.assert_array_equal(packed.numpy().view(np.uint32),
                                  np.asarray(jtd.pack_bf16(jnp.asarray(table))))
    enc, jfn = ((td.encode_flat, jtd.encode_flat) if stochastic
                else (td.encode_split, jtd.encode_split))
    enc_p, jfn_p = ((td.encode_flat_packed, jtd.encode_flat_packed) if stochastic
                    else (td.encode_split_packed, jtd.encode_split_packed))
    for got, want in ((enc(_t(table), rows, cw, cfg), jfn(jnp.asarray(table), jrows, jcw, jcfg)),
                      (enc(bf16, rows, cw, cfg), jfn(jbf16, jrows, jcw, jcfg)),
                      (enc_p(packed, rows, cw, cfg),
                       jfn_p(jtd.pack_bf16(jnp.asarray(table)), jrows, jcw, jcfg))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), rtol=1e-6,
                                   atol=1e-7)
    # packed and bf16 tables give the same features
    np.testing.assert_array_equal(enc_p(packed, rows, cw, cfg).numpy(),
                                  enc(bf16, rows, cw, cfg).numpy())


def test_corner_gather_equals_jax(scripts):
    gt = scripts["bench_torch_gather_by_table"]
    rng = np.random.default_rng(7)
    table = rng.standard_normal((4096, 2)).astype(np.float32)
    idx8 = rng.integers(0, 4096, (500, 8))
    w8 = rng.random((500, 8, 1)).astype(np.float32)
    want = jnp.sum(jnp.asarray(table)[jnp.asarray(idx8)] * jnp.asarray(w8), axis=1)
    _scale_close(gt.corner_gather(_t(table), _t(idx8), _t(w8)).numpy(), want, 1e-6)


# -- U-Net layout ------------------------------------------------------------------


def test_conv_chain_layouts_equal_each_other_and_jax(scripts):
    ul = scripts["bench_torch_unet_layout"]
    jul = _script("bench_unet_layout")
    c, hw = 8, 12
    nchw = ul.conv_inputs(c, hw, "cpu", False, seed=3)
    cl = ul.conv_inputs(c, hw, "cpu", True, seed=3)
    assert cl[0].is_contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        a = ul.conv_chain(*nchw).float().numpy()
        b = ul.conv_chain(*cl).float().numpy()
    _scale_close(b, a, BF16_TOL)
    want = jul.conv_chain_nchw(*(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in nchw))
    _scale_close(a, np.asarray(want, np.float32), BF16_TOL)
    # the JAX script's NHWC chain is the same function
    xh = jnp.asarray(nchw[0].float().numpy(), jnp.bfloat16).transpose(0, 2, 3, 1)
    kh = jnp.asarray(nchw[1].float().numpy(), jnp.bfloat16).transpose(2, 3, 1, 0)
    nhwc = jul.conv_chain_nhwc(xh, kh, kh, *(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                                              for t in nchw[3:]))
    _scale_close(b, np.asarray(nhwc, np.float32).transpose(0, 3, 1, 2), BF16_TOL)


@pytest.mark.parametrize("which", ["sdpa_f32", "sdpa_bf16"])
def test_sdpa_variants_equal_jax(scripts, which):
    ul = scripts["bench_torch_unet_layout"]
    jul = _script("bench_unet_layout")
    rng = np.random.default_rng(8)
    q, k, v = (rng.standard_normal((2, 3, 40, 16)).astype(np.float32) for _ in range(3))
    tq, tk, tv = (_t(a).to(torch.bfloat16) for a in (q, k, v))
    got = getattr(ul, which)(tq, tk, tv).float().numpy()
    want = getattr(jul, which)(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    _scale_close(got, np.asarray(want, np.float32), BF16_TOL)


# -- every study script's run at a tiny size ---------------------------------------


def _tiny_runs(scripts):
    _, tcfg = _tiny_nerf()
    hcfg = tcfg.encoding_sigma
    return {
        "bench_torch_scatter_variants": lambda m: m.run(
            m.build_parser().parse_args(["--m", "4096", "--table", "1024"]), "cpu"),
        "bench_torch_step_ablation": lambda m: m.run("cpu", tcfg, hw=8, budget=256, n_iters=1),
        "bench_torch_eval_ablation": lambda m: m.run("cpu", tcfg, hw=8, budget=1024,
                                                     n_iters=1),
        "bench_torch_encode_split": lambda m: m.run("cpu", hcfg, m=1000, n_iters=1),
        "bench_torch_table_dtype": lambda m: m.run("cpu", hcfg, m=1000, n_iters=1),
        "bench_torch_gather_by_table": lambda m: m.run("cpu", (8, 10), m=1000, m_corner=100,
                                                       t_corner=1024, n_iters=1),
        "bench_torch_unet_layout": lambda m: m.run("cpu", ((8, 8),), ((2, 16, 8),),
                                                   n_iters=1),
        "bench_torch_grid_refresh": lambda m: m.run("cpu", grid=16, iters=1),
    }


@pytest.mark.parametrize("name", STUDIES)
def test_study_script_runs_at_a_tiny_size(scripts, name):
    rows = _tiny_runs(scripts)[name](scripts[name])
    assert rows
    for k, v in rows.items():
        if k.endswith(" mfu"):          # no peak for the CPU
            assert v is None, k
        else:
            assert isinstance(v, float) and np.isfinite(v) and v >= 0, (k, v)
    if name == "bench_torch_scatter_variants":
        assert set(rows) >= {"sort", "index_add_", "v1 kernel", "v2 kernel", "v1 sort+kernel",
                             "v2 sort+kernel", "sort batched",
                             "sort batched, bf16-packed payload", "gather"}
        assert all(rows[k] <= 1e-5 for k in rows if k.endswith("_max_rel_err"))


def test_grid_refresh_main_at_grid_16(scripts, capsys):
    assert scripts["bench_torch_grid_refresh"].main(["--grid", "16", "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "full sweep steady-state" in text and "partial sweep steady-state" in text


# -- the tools ---------------------------------------------------------------------


def test_key_manifests_equal_the_committed_fixtures_byte_for_byte(scripts, tmp_path):
    km = scripts["make_torch_sdxl_key_manifest"]
    assert km.main(["--out-dir", str(tmp_path)]) == 0
    for name in km.NAMES:
        with open(tmp_path / name, "rb") as a, open(os.path.join(FIXTURES, name), "rb") as b:
            assert a.read() == b.read(), name
    assert km.build_parser().parse_args([]).out_dir != os.path.join("tests", "fixtures")


def test_synthetic_scene_equals_the_jax_script(scripts, tmp_path, monkeypatch):
    sc = scripts["make_torch_synthetic_scene"]
    assert sc.main(["--n-views", "4", "--size", "16", "--out", str(tmp_path / "t.npz")]) == 0
    jsc = _script("make_synthetic_scene")
    monkeypatch.setattr(sys, "argv", ["make_synthetic_scene.py", "--n-views", "4", "--size",
                                      "16", "--out", str(tmp_path / "j.npz")])
    jsc.main()
    got, want = np.load(tmp_path / "t.npz"), np.load(tmp_path / "j.npz")
    assert set(got.files) == set(want.files)
    for k in want.files:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert [(c.tolist(), r, b.tolist()) for c, r, b in sc.SPHERES] == \
        [(c.tolist(), r, b.tolist()) for c, r, b in jsc.SPHERES]
    assert os.path.normpath(sc.DEFAULT_OUT) != os.path.join("datasets", "nerf",
                                                            "synthetic_spheres.npz")


def test_synthetic_scene_against_the_committed_file(scripts):
    """At its defaults: the poses and focal equal; 65,188 of the committed
    file's 1,048,576 pixels differ (today's JAX script gives the same
    image as this one, so the committed file predates it)."""
    sc = scripts["make_torch_synthetic_scene"]
    images, poses = sc.render_scene(64, 128)
    committed = np.load(os.path.join(REPO, "datasets", "nerf", "synthetic_spheres.npz"))
    np.testing.assert_array_equal(poses, committed["poses"])
    assert float(committed["focal"]) == 138.0
    differ = int((images != committed["images"]).any(-1).sum())
    assert differ == 65188, differ


def test_weights_drill_at_tiny_size_is_bit_identical(scripts, tmp_path, monkeypatch, capsys):
    from stable_nerf_tpu_torch.models.diffusion import weights as tw
    from stable_nerf_tpu_torch.models.diffusion.unet import tiny_unet_config
    from stable_nerf_tpu_torch.models.diffusion.vae import VAEConfig

    drill = scripts["weights_torch_drill_full_size"]
    ucfg = tiny_unet_config()
    vcfg = VAEConfig(block_out_channels=(16, 32), layers_per_block=1, norm_groups=8)
    for name, patched in (
            ("unet_state_dict_template",
             lambda f: lambda cfg=None, with_ip=False: f(ucfg, with_ip=with_ip)),
            ("vae_state_dict_template", lambda f: lambda cfg=None: f(vcfg)),
            ("load_sdxl", lambda f: lambda d, **kw: f(d, unet_cfg=ucfg, vae_cfg=vcfg, **kw)),
            ("export_unet_state_dict", lambda f: lambda p, cfg=None, include_ip=True: f(
                p, ucfg, include_ip=include_ip)),
            ("export_vae_state_dict", lambda f: lambda p, cfg=None: f(p, vcfg))):
        monkeypatch.setattr(tw, name, patched(getattr(tw, name)))
    assert drill.main(["--dir", str(tmp_path / "ckpt")]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["bit_identical"] is True
    jax_src = open(os.path.join(REPO, "scripts", "weights_drill_full_size.py")).read()
    jax_keys = set(re.findall(r'result\["(\w+)"\]', jax_src)) | {"checkpoint_dir"}
    assert set(result) == jax_keys - {"mismatches"}
    assert result["synthesized"]["unet"]["keys"] == len(tw.unet_state_dict_template())
    assert not os.path.exists(tmp_path / "ckpt")        # removed without --keep
