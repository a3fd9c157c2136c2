"""The port's sequence parallelism (models/diffusion/nn.py::ring_sdpa,
parallel/sp.py, the U-Net's ``sp_axis``) and its sharded serving step
(training/inference.py::make_sharded_inference_step) against the JAX
package's on the CPU.

One launch of four real processes (gloo; tests/mp_torch_worker.py
``cases``, which imports torch only) runs every case on a mesh of its own
sizes over that world; the JAX side runs here on conftest's 8 virtual
devices meanwhile.  Inputs are made with numpy from a seed.

Tolerances, float32: ``ring_sdpa`` within 1e-5 relative (1e-6 absolute)
of JAX's ``ring_sdpa`` and ``sdpa`` and its gradients within 1e-4 (1e-5),
as tests/test_sp.py holds JAX's ring against its sdpa; bf16 within 2e-2
absolutely of JAX's bf16 ``sdpa``.  The sequence-parallel U-Net within
2e-5 of JAX's ``unet_apply`` (and its attention maps), as test_sp.py
holds JAX's.  The sharded inference step (tp 2 × sp 2, 3 DDIM steps,
JAX's draws injected) within ``1e-4 · steps`` of each key's largest entry
of JAX's unsharded step, as tests/test_torch_inference.py holds the
unsharded port.
"""

import concurrent.futures
import os
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

import __graft_entry__ as ge
from stable_nerf_tpu.models.diffusion import DDIMScheduler as JDDIMScheduler
from stable_nerf_tpu.models.diffusion import sd_network as jsd
from stable_nerf_tpu.models.diffusion import unet as junet
from stable_nerf_tpu.models.diffusion.nn import ring_sdpa as jring_sdpa
from stable_nerf_tpu.models.diffusion.nn import sdpa as jsdpa
from stable_nerf_tpu.models.nerf import grid_init as jgrid_init
from stable_nerf_tpu.models.nerf import nerf_init as jnerf_init
from stable_nerf_tpu.parallel.sp import make_mesh_3d as jmake_mesh_3d
from stable_nerf_tpu.parallel.sp import make_sp_unet_apply as jmake_sp_unet_apply
from stable_nerf_tpu.training import inference as jinf
from stable_nerf_tpu_torch import convert
from stable_nerf_tpu_torch import train as tcli
from stable_nerf_tpu_torch.models.diffusion import unet as tunet
from stable_nerf_tpu_torch.models.diffusion.sd_network import (init_ip_from_unet,
                                                               sd_network_init)
from stable_nerf_tpu_torch.models.nerf.grid import OccupancyGridState
from stable_nerf_tpu_torch.models.nerf.network import nerf_init
from stable_nerf_tpu_torch.parallel import make_mesh_3d
from test_torch_inference import _close_to_scale
from test_torch_inference import _tiny_joint_config as _serve_config

torch.set_num_threads(2)
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "mp_torch_worker.py")
WORLD = 4
TIMEOUT_S = 120          # the launch
RING = (2, 4, 64, 16)    # B, H, S, D of tests/test_sp.py
STEPS = 3


def _unet_case(seed=4):
    """The tiny U-Net's weights (the port's init) and its inputs at 8² and
    6² latents, numpy from a seed, in both layouts."""
    jcfg = junet.tiny_unet_config()
    tcfg = convert.config_from_jax(jcfg)
    params = init_ip_from_unet({"unet": tunet.unet_init(
        torch.Generator().manual_seed(seed), tcfg)})["unet"]
    rng = np.random.default_rng(seed)

    def inputs(h, b=2):
        return {"sample": rng.standard_normal((b, 4, h, h)).astype(np.float32),
                "t": np.linspace(10.0, 900.0, b).astype(np.float32),
                "ehs": rng.standard_normal((b, 4, 48)).astype(np.float32),
                "text_embeds": rng.standard_normal((b, 32)).astype(np.float32),
                "time_ids": np.tile(np.float32([[8, 8, 0, 0, 8, 8]]), (b, 1))}

    return jcfg, tcfg, params, {8: inputs(8), 6: inputs(6)}


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _launch(inputs, out):
    torch.save(inputs, out / "inputs.pt")
    rc = tcli.launch_local([], WORLD, command=[sys.executable, WORKER, "cases",
                                               str(out / "inputs.pt"), str(out)],
                           timeout=TIMEOUT_S)
    assert rc == 0, f"a cases worker exited {rc}"
    return [torch.load(out / f"cases_{r}.pt", weights_only=False) for r in range(WORLD)]


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    out = tmp_path_factory.mktemp("sp")
    rng = np.random.default_rng(11)
    qkv = [rng.standard_normal(RING).astype(np.float32) for _ in range(3)]
    jcfg, tcfg, uparams, uin = _unet_case()
    # the serving step: weights, a sparse grid, a batch, JAX's draws
    scfg = _serve_config()
    stcfg = convert.config_from_jax(scfg)
    seed_tree = {"sd": init_ip_from_unet(sd_network_init(0, stcfg.sd, device="cpu")),
                 "nerf": nerf_init(1, stcfg.nerf, device="cpu")}
    seed_tree["nerf"]["hash"]["table"].mul_(1e4)
    like = jax.eval_shape(lambda: {
        "sd": jsd.sd_network_init(jax.random.PRNGKey(0), scfg.sd),
        "nerf": jnerf_init(jax.random.PRNGKey(1), scfg.nerf)})
    jparams = jax.tree.map(jnp.asarray, convert.params_to_jax(seed_tree, like=like))
    sparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), like=seed_tree)
    grid = jgrid_init(scfg.nerf)
    grid = grid._replace(occ=jnp.asarray(rng.random(grid.occ.shape) < 0.4))
    batch = ge._make_batch(scfg, 2, jax.random.PRNGKey(1))
    key = jax.random.PRNGKey(9)
    k_vae, k_init = jax.random.split(key)
    enc = scfg.latent_hw
    draws = _torch({"vae_eps": jax.random.normal(k_vae, (2, 4, enc, enc), jnp.float32),
                    "init_latents": jax.random.normal(k_init, (2, 4, enc, enc))})

    unet = dict(kind="unet", params=uparams, cfg=tcfg)
    q, k, v = (torch.from_numpy(x) for x in qkv)
    cases = (
        [dict(name=f"ring{n}", kind="ring", sp=n, tp=1, q=q, k=k, v=v) for n in (1, 2, 4)]
        + [dict(name="ring4_bf16", kind="ring", sp=4, tp=1,
                q=q.bfloat16(), k=k.bfloat16(), v=v.bfloat16()),
           dict(unet, name="sp2", sp=2, tp=1, inputs=_torch(uin[8])),
           dict(unet, name="sp2tp2", sp=2, tp=2, inputs=_torch(uin[8])),
           dict(unet, name="capture_sp2tp2", sp=2, tp=2, capture=True,
                inputs=_torch(uin[8])),
           dict(unet, name="indivisible", sp=2, tp=1, inputs=_torch(uin[6]))]
        + [dict(name=f"infer_g{g}", kind="infer", sp=2, tp=2, steps=STEPS, guidance=g,
                cfg=stcfg, params=sparams, draws=draws,
                grid=OccupancyGridState(*(torch.from_numpy(np.array(a)) for a in grid)),
                batch=_torch(batch)) for g in (1.0, 5.0)])

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        launched = pool.submit(_launch, {"cases": cases}, out)
        jax_side = {}
        # ring attention: JAX's ring at n over a seq mesh, and its sdpa
        spec = P(None, None, "seq", None)
        jq, jk, jv = (jnp.asarray(x) for x in qkv)
        for n in (2, 4):
            ring = jax.jit(jax.shard_map(
                partial(jring_sdpa, axis="seq"),
                mesh=JMesh(np.asarray(jax.devices()[:n]), ("seq",)),
                in_specs=(spec,) * 3, out_specs=spec))
            jax_side[f"ring{n}"] = (ring(jq, jk, jv), jax.grad(
                lambda a, b, c: jnp.sum(ring(a, b, c) ** 2), argnums=(0, 1, 2))(jq, jk, jv))
        jax_side["sdpa"] = (jsdpa(jq, jk, jv), jax.grad(
            lambda a, b, c: jnp.sum(jsdpa(a, b, c) ** 2), argnums=(0, 1, 2))(jq, jk, jv))
        jax_side["sdpa_bf16"] = jsdpa(*(x.astype(jnp.bfloat16) for x in (jq, jk, jv)))
        # the U-Net: JAX's unet_apply (maps captured) and its SP apply at sp=2
        jup = jax.tree.map(jnp.asarray, convert.params_to_jax(uparams))
        x = {k: jnp.asarray(v) for k, v in uin[8].items()}
        jax_side["unet"] = junet.unet_apply(
            jup, x["sample"], x["t"], x["ehs"], added_text_embeds=x["text_embeds"],
            added_time_ids=x["time_ids"], cfg=jcfg, capture_ip_attn_maps=True)
        placed, fn = jmake_sp_unet_apply(jup, jmake_mesh_3d(2, sp=2), jcfg)
        jax_side["sp2"] = fn(placed, x["sample"], x["t"], x["ehs"], x["text_embeds"],
                             x["time_ids"])
        # the unsharded serving step
        for g in (1.0, 5.0):
            jstep = jax.jit(jinf.make_inference_step(
                scfg, JDDIMScheduler.create(scfg.sd.scheduler), STEPS,
                compute_dtype=jnp.float32, guidance_scale=g))
            jax_side[f"infer_g{g}"] = jstep(jparams, grid, batch, key)
        ranks = launched.result()
    return {"ranks": ranks, "jax": jax_side}


def _seq_blocks(ranks, name, n, get):
    """The whole sequence from the seq ranks 0..n-1 (model innermost of
    size 1: rank i is seq index i of data index 0)."""
    return np.concatenate([np.asarray(get(ranks[i][name]), np.float32)
                           for i in range(n)], axis=2)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_ring_sdpa_forward_and_gradients_match_jax(world4, n):
    """Exact attention whatever the ring's size (n = 1 is sdpa): the output
    and the gradients of sum(out²) against JAX's ring_sdpa and sdpa."""
    ranks, jx = world4["ranks"], world4["jax"]
    got = _seq_blocks(ranks, f"ring{n}", n, lambda r: r["out"])
    grads = [_seq_blocks(ranks, f"ring{n}", n, lambda r, i=i: r["grads"][i])
             for i in range(3)]
    refs = [jx["sdpa"]] + ([jx[f"ring{n}"]] if n > 1 else [])
    for want, want_grads in refs:
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
        for g, w in zip(grads, want_grads):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-5)
    # the forward's n - 1 hops of k and v, the backward's of k, v, dk and dv
    assert ranks[0][f"ring{n}"]["hops"] == 6 * (n - 1)


def test_ring_sdpa_bf16_follows_sdpa_dtype_rules(world4):
    ranks = world4["ranks"]
    assert ranks[0]["ring4_bf16"]["out"].dtype == torch.bfloat16
    got = _seq_blocks(ranks, "ring4_bf16", 4, lambda r: r["out"].float())
    np.testing.assert_allclose(got, np.asarray(world4["jax"]["sdpa_bf16"], np.float32),
                               rtol=0, atol=2e-2)


@pytest.mark.parametrize("name", ["sp2", "sp2tp2"])
def test_sp_unet_matches_jax(world4, name):
    """Every rank's sequence-parallel (× tensor-parallel) U-Net output
    against JAX's unet_apply and, at sp=2, JAX's make_sp_unet_apply."""
    want, _ = world4["jax"]["unet"]
    for r in world4["ranks"]:
        np.testing.assert_allclose(r[name]["eps"].numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)
        if name == "sp2":
            np.testing.assert_allclose(r[name]["eps"].numpy(),
                                       np.asarray(world4["jax"]["sp2"]), rtol=2e-5,
                                       atol=2e-5)


def test_sp_tp_attention_maps_gather_heads_and_queries(world4):
    """The captured ip maps come back whole (all heads, all queries) on
    every rank under sp 2 × tp 2."""
    want_eps, want = world4["jax"]["unet"]
    for r in world4["ranks"]:
        got = r["capture_sp2tp2"]
        np.testing.assert_allclose(got["eps"].detach().numpy(), np.asarray(want_eps),
                                   rtol=2e-5, atol=2e-5)
        assert len(got["maps"]) == len(want["ip_attn_maps"]) > 0
        for g, w in zip(got["maps"], want["ip_attn_maps"]):
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=2e-5,
                                       atol=2e-5)


def test_sp_indivisible_sequence_raises(world4):
    """6² latents: 3² = 9 tokens at the transformer level, 9 % 2 != 0."""
    for r in world4["ranks"]:
        assert "not divisible" in r["indivisible"]["error"]


@pytest.mark.parametrize("guidance", [1.0, 5.0])
def test_sharded_inference_step_matches_jax_unsharded(world4, guidance):
    """tp 2 × sp 2 serving, the unconditional pass under guidance through
    the same sharded U-Net: every key against JAX's unsharded step, and the
    ranks' denoised images bit-equal (the same draws on every rank)."""
    want = world4["jax"][f"infer_g{guidance}"]
    outs = [r[f"infer_g{guidance}"] for r in world4["ranks"]]
    for out in outs:
        assert set(out) == set(want)
        for k, w in want.items():
            assert tuple(out[k].shape) == w.shape, k
            _close_to_scale(out[k].numpy(), w, 1e-4 * STEPS, k)
    for out in outs[1:]:
        assert torch.equal(out["denoised_image"], outs[0]["denoised_image"])


def test_make_mesh_3d_refuses_a_world_sp_tp_does_not_divide():
    with pytest.raises(ValueError, match="not divisible by seq\\*model=4"):
        make_mesh_3d("cpu", sp=2, tp=2)
