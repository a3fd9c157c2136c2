"""The port's tensor parallelism (parallel/tp.py, the U-Net's ``tp_axis``,
the loop's ``tensor_parallel``, FSDP × TP and the CLI's
``--tensor-parallel``/``--sp``) against the JAX package's on the CPU.

Real processes over gloo (tests/mp_torch_worker.py, torch only, started by
``train.launch_local`` with a timeout a launch): one world of four runs the
U-Net at tp 2 and 4 and dp 2 × tp 2 and the joint step at data 2 × model 2,
tensor-parallel and fully sharded as well; one world of two runs the joint
step at tp 2.  The JAX side runs here on conftest's 8 virtual devices.

Tolerances, float32: the TP U-Net within 2e-5 of JAX's ``unet_apply`` and
``make_tp_unet_apply``, as tests/test_tp.py holds JAX's.  The joint steps
against JAX's single-device step on the global batch of 2 with its draws
(tests/test_torch_parallel.py's tolerances): losses within 1e-5 relative,
each updated trainable leaf's update within 1e-3 of JAX's in L2 norm (the
color MLP aside: Adam's first step is lr·g/(|g| + eps), its gradients sit
near eps).  The step with the whole U-Net trainable against the port's own
single-process step: Adam's first moment (linear in the gradient) within
1e-5 of the leaf's largest entry (float32 sums in another order), the
GEGLU leaves' moments unpermuted; each updated entry within 2·lr (Adam's
first step moves an entry by about lr whatever its gradient's size).
"""

import concurrent.futures
import dataclasses
import functools
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import __graft_entry__ as ge
from stable_nerf_tpu.models.diffusion import DDIMScheduler as JDDIMScheduler
from stable_nerf_tpu.models.diffusion import sd_network as jsd
from stable_nerf_tpu.models.diffusion import unet as junet
from stable_nerf_tpu.models.nerf import grid_init as jgrid_init
from stable_nerf_tpu.models.nerf import nerf_init as jnerf_init
from stable_nerf_tpu.parallel import tp as jtp
from stable_nerf_tpu.parallel.fsdp import joint_fsdp_specs as jfsdp_specs
from stable_nerf_tpu.training import joint as jj
from stable_nerf_tpu.utils.pytree import partition as jpartition
from stable_nerf_tpu_torch import convert
from stable_nerf_tpu_torch import train as tcli
from stable_nerf_tpu_torch.data.dataset import StableNeRFDataset as TDataset
from stable_nerf_tpu_torch.models.diffusion.scheduler import DDIMScheduler
from stable_nerf_tpu_torch.models.diffusion.sd_network import (init_ip_from_unet,
                                                               sd_network_init)
from stable_nerf_tpu_torch.models.nerf.grid import OccupancyGridState
from stable_nerf_tpu_torch.models.nerf.network import nerf_init
from stable_nerf_tpu_torch.parallel import (joint_fsdp_specs, make_mesh_2d,
                                            permute_unet_for_tp, unet_tp_specs)
from stable_nerf_tpu_torch.parallel.tp import _geglu_col_perm
from stable_nerf_tpu_torch.training import joint as tj
from stable_nerf_tpu_torch.training import loop as tloop
from stable_nerf_tpu_torch.training.checkpoints import CheckpointManager
from stable_nerf_tpu_torch.utils.tree import (combine, partition, tree_leaves,
                                              tree_leaves_with_path, tree_map)
from test_torch_joint import _tiny_joint_config
from test_torch_parallel import _draws
from test_torch_sp import _unet_case

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "mp_torch_worker.py")
TIMEOUT_S = 120          # each multi-process launch
B = 2                    # the joint steps' global batch
KEY = 3


def _launch(world, inputs, out):
    torch.save(inputs, out / "inputs.pt")
    rc = tcli.launch_local([], world, command=[sys.executable, WORKER, "cases",
                                               str(out / "inputs.pt"), str(out)],
                           timeout=TIMEOUT_S)
    assert rc == 0, f"a cases worker exited {rc}"
    return [torch.load(out / f"cases_{r}.pt", weights_only=False) for r in range(world)]


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _spec_dim(spec, name):
    """The dimension a JAX PartitionSpec puts on mesh axis ``name``, or None."""
    return list(spec).index(name) if name in spec else None


def _jax_specs(tree):
    return dict((jax.tree_util.keystr(p), s) for p, s in
                jax.tree_util.tree_leaves_with_path(tree, is_leaf=lambda x: isinstance(x, P)))


# -- the layout, without processes ----------------------------------------------

@pytest.mark.parametrize("hidden,tp", [(16, 4), (512, 2), (512, 4), (10240, 10)])
def test_geglu_col_perm_equals_jax(hidden, tp):
    np.testing.assert_array_equal(_geglu_col_perm(hidden, tp),
                                  jtp._geglu_col_perm(hidden, tp))


@pytest.mark.parametrize("tp", [2, 4])
def test_permute_unet_for_tp_and_inverse_equal_jax(tp):
    """Leaf for leaf against JAX's permutation of the same weights; the
    inverse restores every leaf bit for bit; the GEGLU columns move."""
    _, _, params, _ = _unet_case()
    got = permute_unet_for_tp(params, tp)
    want = jtp.permute_unet_for_tp(jax.tree.map(jnp.asarray,
                                                convert.params_to_jax(params)), tp)
    back = permute_unet_for_tp(got, tp, inverse=True)
    g_leaves = tree_leaves_with_path(convert.params_from_jax(
        jax.tree.map(np.asarray, want), like=params))
    for (path, a), (_, w), b, x in zip(tree_leaves_with_path(got), g_leaves,
                                       tree_leaves(back), tree_leaves(params)):
        assert torch.equal(a, w), path
        assert torch.equal(b, x), path
    blk = ("mid_block", "attentions", 0, "blocks", 0, "ff_geglu", "kernel")
    before, after = params, got
    for k in blk:
        before, after = before[k], after[k]
    assert not torch.equal(before, after)


def test_unet_tp_specs_equal_jax():
    _, _, params, _ = _unet_case()
    want = _jax_specs(jtp.unet_tp_specs(convert.params_to_jax(params)))
    got = dict(tree_leaves_with_path(unet_tp_specs(params)))
    # the port's path of a [in, out] kernel is JAX's: linears keep their layout
    assert set(got) == set(want)
    assert {k: _spec_dim(s, "model") for k, s in want.items()} == got
    blk = "['mid_block']['attentions'][0]['blocks'][0]"
    assert got[blk + "['attn1']['to_q']['kernel']"] == 1
    assert got[blk + "['attn1']['to_out']['kernel']"] == 0
    assert got[blk + "['attn1']['to_out']['bias']"] is None
    assert got[blk + "['ff_geglu']['bias']"] == 0
    assert got[blk + "['attn2']['to_k_ip']['kernel']"] == 1


def _joint_tree():
    jcfg = _tiny_joint_config()
    tcfg = convert.config_from_jax(jcfg)
    seed_tree = {"sd": init_ip_from_unet(sd_network_init(0, tcfg.sd, device="cpu")),
                 "nerf": nerf_init(1, tcfg.nerf, device="cpu")}
    like = jax.eval_shape(lambda: {
        "sd": jsd.sd_network_init(jax.random.PRNGKey(0), jcfg.sd),
        "nerf": jnerf_init(jax.random.PRNGKey(1), jcfg.nerf)})
    return jcfg, tcfg, seed_tree, like


@pytest.mark.parametrize("data", [2, 4])
@pytest.mark.parametrize("min_size", [1 << 8, 1 << 15])
def test_fsdp_tp_specs_equal_jax(data, min_size):
    """FSDP × TP: every leaf's data dimension is the one JAX's
    ``joint_fsdp_specs(..., tp_axis="model")`` gives at data × model 2, and
    never TP's dimension."""
    _, _, params, like = _joint_tree()
    jspecs = _jax_specs(jfsdp_specs(like, jtp.make_mesh_2d(2 * data, tp=2),
                                    tp_axis="model", min_size=min_size))
    got = dict(tree_leaves_with_path(joint_fsdp_specs(params, data, tp_axis="model",
                                                      min_size=min_size)))
    # the NeRF stays replicated in both (its JAX paths are attributes)
    assert all(s == P() for k, s in jspecs.items() if not k.startswith("['sd']"))
    assert all(d is None for k, d in got.items() if k.startswith("['nerf']"))
    got = {k: d for k, d in got.items() if k.startswith("['sd']")}
    jspecs = {k: s for k, s in jspecs.items() if k.startswith("['sd']")}
    assert set(got) == set(jspecs)
    assert got == {k: _spec_dim(s, "data") for k, s in jspecs.items()}
    tp_dims = dict(tree_leaves_with_path(unet_tp_specs(params["sd"]["unet"]),
                                         "['sd']['unet']"))
    both = [k for k, d in got.items() if d is not None and tp_dims.get(k) is not None]
    assert both and all(got[k] != tp_dims[k] for k in both)


# -- the processes ------------------------------------------------------------------

@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """One launch of four ranks and one of two (the second after the
    first, both while JAX computes its references here)."""
    jcfg_u, tcfg_u, uparams, _ = _unet_case()
    rng = np.random.default_rng(7)

    def unet_inputs(b):
        return {"sample": rng.standard_normal((b, 4, 8, 8)).astype(np.float32),
                "t": np.linspace(10.0, 900.0, b).astype(np.float32),
                "ehs": rng.standard_normal((b, 4, 48)).astype(np.float32),
                "text_embeds": rng.standard_normal((b, 32)).astype(np.float32),
                "time_ids": np.tile(np.float32([[8, 8, 0, 0, 8, 8]]), (b, 1))}

    uin = {2: unet_inputs(2), 4: unet_inputs(4)}
    jcfg, tcfg, seed_tree, like = _joint_tree()
    jparams = jax.tree.map(jnp.asarray, convert.params_to_jax(seed_tree, like=like))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), like=seed_tree)
    grid = jgrid_init(jcfg.nerf)
    grid = grid._replace(occ=jnp.ones_like(grid.occ))
    tgrid = OccupancyGridState(*(torch.from_numpy(np.array(a)) for a in grid))
    batch = ge._make_batch(jcfg, B, jax.random.PRNGKey(1))
    key = jax.random.PRNGKey(KEY)
    draws = _torch(_draws(key, B, jcfg.latent_hw))
    tcfg_sd = dataclasses.replace(tcfg, train=dataclasses.replace(tcfg.train,
                                                                  trainable_scope="sd"))
    unet = dict(kind="unet", params=uparams, cfg=tcfg_u, sp=1)
    train = dict(kind="train", sp=1, tp=2, cfg=tcfg, params=params, grid=tgrid,
                 batch=_torch(batch), draws=draws, min_size=1 << 8)
    four = [dict(unet, name="tp2", tp=2, inputs=_torch(uin[2])),
            dict(unet, name="tp4", tp=4, inputs=_torch(uin[2])),
            dict(unet, name="dp2tp2", tp=2, data_axis=True, inputs=_torch(uin[4])),
            dict(train, name="train_dp2tp2"),
            dict(train, name="train_fsdp_dp2tp2", fsdp=True)]
    two = [dict(train, name="train_tp2"),
           dict(train, name="train_tp2_sd", cfg=tcfg_sd, moments=True)]
    outs = [tmp_path_factory.mktemp("four"), tmp_path_factory.mktemp("two")]

    def both():
        return _launch(4, {"cases": four}, outs[0]), _launch(2, {"cases": two}, outs[1])

    with concurrent.futures.ThreadPoolExecutor(1) as pool, pytest.MonkeyPatch.context() as mp:
        launched = pool.submit(both)
        jx = {}
        jup = jax.tree.map(jnp.asarray, convert.params_to_jax(uparams))
        for b in (2, 4):
            x = {k: jnp.asarray(v) for k, v in uin[b].items()}
            args = (x["sample"], x["t"], x["ehs"], x["text_embeds"], x["time_ids"])
            jx[f"unet{b}"] = junet.unet_apply(jup, *args[:3], added_text_embeds=args[3],
                                              added_time_ids=args[4], cfg=jcfg_u)
            for name, mesh, data_axis in (
                    [("tp2", jtp.make_mesh_2d(2, tp=2), None),
                     ("tp4", jtp.make_mesh_2d(4, tp=4), None)] if b == 2 else
                    [("dp2tp2", jtp.make_mesh_2d(4, tp=2), "data")]):
                placed, fn = jtp.make_tp_unet_apply(jup, mesh, jcfg_u, data_axis=data_axis)
                jx[name] = fn(placed, *args)
        # JAX's single-device step on the global batch, held in float32
        mp.setattr(jj, "forward_iteration",
                   functools.partial(jj.forward_iteration, compute_dtype=jnp.float32))
        mask = jj.joint_trainable_mask(jparams)
        opt = jj.make_optimizer(jcfg.train)
        single = jax.jit(jj.make_train_step(jcfg, JDDIMScheduler.create(jcfg.sd.scheduler),
                                            opt, mask))
        p_one, _, m_one = single(jparams, opt.init(jpartition(jparams, mask)[0]), grid,
                                 batch, key)
        jx["train"] = (jax.tree.map(np.asarray, p_one), m_one, mask)
        four_r, two_r = launched.result()
    # the port's own single-process step with the whole U-Net trainable
    p = tree_map(torch.clone, params)
    tmask = tj.joint_trainable_mask(p, "sd")
    topt = tj.make_optimizer(tcfg_sd.train, p, tmask)
    m = tj.make_train_step(tcfg_sd, DDIMScheduler.create(tcfg.sd.scheduler, device="cpu"),
                           topt, compute_dtype=torch.float32, device="cpu")(
        p, tgrid, _torch(batch), draws=draws)
    paths = tj.optimizer_param_paths(p, tmask)
    port_sd = {"metrics": {k: float(v) for k, v in m.items()},
               "trainable": partition(p, tmask)[0],
               "moments": {paths[i]: s["exp_avg"]
                           for i, s in topt.state_dict()["state"].items()}}
    return {"four": four_r, "two": two_r, "jax": jx, "before": params, "jparams": jparams,
            "port_sd": port_sd, "lr": tcfg.train.lr}


@pytest.mark.parametrize("name,b", [("tp2", 2), ("tp4", 2), ("dp2tp2", 4)])
def test_tp_unet_matches_jax(worlds, name, b):
    """Every rank's output against JAX's unet_apply and its
    make_tp_unet_apply on the same mesh."""
    for r in worlds["four"]:
        got = r[name]["eps"].numpy()
        for want in (worlds["jax"][f"unet{b}"], worlds["jax"][name]):
            np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("world,name", [(2, "train_tp2"), (4, "train_dp2tp2"),
                                        (4, "train_fsdp_dp2tp2")])
def test_tp_joint_step_matches_jax_single_device(worlds, world, name):
    """World 2 (tp 2), world 4 (data 2 × model 2) and world 4 fully sharded
    over data as well: the global batch's step, every rank the same
    losses and updated trainables."""
    ranks = [r[name] for r in worlds["two" if world == 2 else "four"]]
    want_params, want_m, mask = worlds["jax"]["train"]
    for r in ranks[1:]:
        assert r["metrics"] == ranks[0]["metrics"]
        for a, b in zip(tree_leaves(r["trainable"]), tree_leaves(ranks[0]["trainable"])):
            assert a is None and b is None or torch.equal(a, b)
    for k in ("loss", "sd_loss", "nerf_loss"):
        np.testing.assert_allclose(ranks[0]["metrics"][k], float(want_m[k]), rtol=1e-5,
                                   err_msg=k)
    before = convert.params_to_jax(worlds["before"], like=worlds["jparams"])
    got = convert.params_to_jax(combine(ranks[0]["trainable"], worlds["before"]),
                                like=worlds["jparams"])
    n = 0
    for (path, g), w, b, m in zip(jax.tree_util.tree_leaves_with_path(got),
                                  jax.tree.leaves(want_params), jax.tree.leaves(before),
                                  jax.tree.leaves(mask)):
        name_ = jax.tree_util.keystr(path)
        if not m:
            np.testing.assert_array_equal(g, b, err_msg=name_)
            continue
        if "color_mlp" in name_:
            continue
        upd = np.asarray(w) - np.asarray(b)
        err = np.linalg.norm((np.asarray(g) - np.asarray(b)) - upd) / np.linalg.norm(upd)
        assert err <= 1e-3, (name_, err)
        n += 1
    assert n > 10
    if "fsdp" in name:
        # TP's slices sharded over data: some leaves carry both cuts
        assert ranks[0]["specs"]


def test_tp_step_with_the_unet_trainable_matches_one_process(worlds):
    """scope "sd": the U-Net's sharded leaves update too; their Adam moments
    come back whole and unpermuted (GEGLU included) and equal the port's
    single-process step's, and so do the updates."""
    want = worlds["port_sd"]
    for r in (x["train_tp2_sd"] for x in worlds["two"]):
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(r["metrics"][k], v, rtol=1e-5, err_msg=k)
        assert set(r["moments"]) == set(want["moments"])
        geglu = [p for p in want["moments"] if "ff_geglu" in p]
        assert geglu
        for path, w in want["moments"].items():
            scale = max(float(w.abs().max()), 1e-30)
            np.testing.assert_allclose(r["moments"][path].numpy(), w.numpy(), rtol=0,
                                       atol=1e-5 * scale, err_msg=path)
        # Adam moves an entry by about lr whatever its gradient's size: where
        # the gradient sits near eps the two orders of summation may flip it
        lr = worlds["lr"]
        for (path, g), w in zip(tree_leaves_with_path(r["trainable"]),
                                tree_leaves(want["trainable"])):
            if g is not None:
                assert float((g - w.detach()).abs().max()) <= 2 * lr, path

def test_make_mesh_2d_refuses_a_world_tp_does_not_divide():
    with pytest.raises(ValueError, match="1 processes not divisible by model=2"):
        make_mesh_2d("cpu", tp=2)


# -- the CLI across two processes ----------------------------------------------------

CLI = ["--tiny", "--dataset", "nerf", "--image-size", "32", "--latent-size", "16",
       "--max-steps", "16", "--max-steps-eval", "16", "--num-inference-steps", "2",
       "--inference-every", "1", "--checkpoint-every", "1", "--device", "cpu"]
VIEWS = 12               # a 9 / 1 / 2 split: 9 train steps a rank (one data rank)


@pytest.fixture(scope="module")
def cli_tp(tmp_path_factory):
    """``--tensor-parallel 2`` over two ``--coordinator`` processes for one
    epoch, then ``--inference --tensor-parallel 2`` and ``--inference
    --sp 2`` on its workdir."""
    out = tmp_path_factory.mktemp("cli_tp")
    root = out / "data"
    scene = np.load(os.path.join(REPO, "datasets", "nerf", "synthetic_spheres.npz"))
    os.makedirs(root / "nerf")
    np.savez(root / "nerf" / "tiny_nerf_data.npz", images=scene["images"][:VIEWS],
             poses=scene["poses"][:VIEWS], focal=scene["focal"])
    workdir = str(out / "work")
    flags = CLI + ["--data-root", str(root), "--workdir", workdir]
    run = {"root": str(root), "workdir": workdir, "renders": {}}
    rc = tcli.launch_local(flags + ["--tensor-parallel", "2", "--epochs", "1"], 2,
                           command=[sys.executable, WORKER, "cli", str(out)],
                           timeout=TIMEOUT_S)
    assert rc == 0
    run["ranks"] = [torch.load(out / f"cli_{r}.pt", weights_only=False) for r in range(2)]
    for name, extra in (("tp", ["--tensor-parallel", "2"]), ("sp", ["--sp", "2"])):
        rc = tcli.launch_local(flags + ["--inference"] + extra, 2, timeout=TIMEOUT_S)
        assert rc == 0, name
        renders = os.path.join(workdir, "renders")
        run["renders"][name] = sorted(os.listdir(renders))
        shutil.rmtree(renders)
    return run


def test_cli_tensor_parallel_trains_rank0_writes(cli_tp):
    r0, r1 = cli_tp["ranks"]
    with open(os.path.join(cli_tp["workdir"], "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [(r["epoch"], r.get("kind")) for r in records] == [(0, None), (0, "inference")]
    assert sorted(os.listdir(os.path.join(cli_tp["workdir"], "checkpoints"))) == ["1.pt"]
    # the returned trees are whole and equal on both ranks
    la, lb = tree_leaves(r0["params"]), tree_leaves(r1["params"])
    assert len(la) == len(lb) and all(torch.equal(a, b) for a, b in zip(la, lb))
    assert r0["history"][0]["train_loss"] == r1["history"][0]["train_loss"]
    assert np.isfinite(r0["history"][0]["val_loss"])


def test_cli_tp_checkpoint_is_single_device_and_restores_bit_for_bit(cli_tp, tmp_path):
    """On disk the GEGLU kernels (frozen here) are the init's, unpermuted;
    a single-process resume with nothing to do returns the run's state."""
    cfg = tcli.build_config(tcli.build_parser().parse_args(CLI))
    raw = CheckpointManager(os.path.join(cli_tp["workdir"], "checkpoints")).restore()
    init = tloop.build_initial_params(cfg, 0, 1, device="cpu", log_fn=lambda m: None)
    disk, fresh = raw["params"]["sd"]["unet"], init["sd"]["unet"]
    n = 0
    for (path, a), b in zip(tree_leaves_with_path(disk), tree_leaves(fresh)):
        if "ff_geglu" in path:
            assert torch.equal(a, b), path
            n += 1
    assert n > 0
    workdir = str(tmp_path / "w")
    shutil.copytree(cli_tp["workdir"], workdir)
    params, grid, history = tloop.train(
        cfg, TDataset("nerf", shape=32, encoded_shape=16, root=cli_tp["root"]),
        workdir=workdir, epochs=1, resume=True, log_fn=lambda m: None, device="cpu")
    assert history == []
    la, lb = tree_leaves(params), tree_leaves(cli_tp["ranks"][0]["params"])
    assert len(la) == len(lb) and all(torch.equal(a, b) and a.dtype == b.dtype
                                      for a, b in zip(la, lb))
    assert all(torch.equal(a, b) for a, b in zip(grid, cli_tp["ranks"][0]["grid"]))


@pytest.mark.parametrize("name", ["tp", "sp"])
def test_cli_sharded_inference_writes_once(cli_tp, name):
    """Both ranks serve the test split sharded; rank 0 alone writes its two
    denoised and two target views."""
    got = cli_tp["renders"][name]
    assert len(got) == 4
    assert sum(f.startswith("denoised_") for f in got) == 2
