"""The port's training across processes (stable_nerf_tpu_torch/parallel/,
the U-Net's remat, the loop's and the CLI's parallel paths) against the
JAX package's on the CPU.

Two real processes (gloo; started by ``train.launch_local`` on a free
port, each with one thread; tests/mp_torch_worker.py, which imports torch
only) form a world of 2.  The JAX side runs here, on ``make_mesh(2)`` of
conftest's 8 virtual devices.  Every multi-process launch has its own
timeout, so a hung rank fails its test.

* The least-squares step of tests/test_joint_training.py at world 2: the
  gradient is the global batch's mean, not the sum (float32, 1e-5).
* The data-parallel joint step at world 2 against JAX's
  ``make_parallel_train_step(make_train_step(..., pmean_axis="data"))``,
  each rank fed JAX's draws of ``fold_in(key, rank)``; the fully-sharded
  step against JAX's single-device step on the global batch (which JAX's
  tests/test_fsdp.py holds equal to its FSDP step), each rank fed its rows
  of the global draws.  Tolerances of tests/test_torch_joint.py: losses
  within 1e-5 relative; each updated trainable leaf's update within 1e-3
  of JAX's in L2 norm (the color MLP aside: Adam's first step is
  lr·g/(|g| + eps), and its gradients sit near eps).
* The sharded leaves are the non-``P()`` leaves of JAX's
  ``joint_fsdp_specs``; a rank holds about 1/world of the shardable bytes.
* The remat U-Net's gradients equal the plain U-Net's bit for bit, and
  JAX's remat U-Net's within 1e-4 of each leaf's largest entry.
* The CLI with ``--coordinator`` over two processes: rank 0 alone writes,
  the grid is bit-equal across ranks, the checkpoint (data-parallel or
  fully-sharded) restores into a single-process run bit for bit, and a
  single-process checkpoint into a fully-sharded run.
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

import __graft_entry__ as ge
from stable_nerf_tpu.models.diffusion import DDIMScheduler as JDDIMScheduler
from stable_nerf_tpu.models.diffusion import sd_network as jsd
from stable_nerf_tpu.models.diffusion import unet as junet
from stable_nerf_tpu.models.nerf import grid_init as jgrid_init
from stable_nerf_tpu.models.nerf import nerf_init as jnerf_init
from stable_nerf_tpu.parallel import make_mesh as jmake_mesh
from stable_nerf_tpu.parallel import make_parallel_train_step as jparallel_step
from stable_nerf_tpu.parallel import replicate as jreplicate
from stable_nerf_tpu.parallel import shard_batch as jshard_batch
from stable_nerf_tpu.parallel.fsdp import joint_fsdp_specs as jfsdp_specs
from stable_nerf_tpu.training import joint as jj
from stable_nerf_tpu.utils.pytree import partition as jpartition
from stable_nerf_tpu_torch import convert
from stable_nerf_tpu_torch import train as tcli
from stable_nerf_tpu_torch.data.dataset import StableNeRFDataset as TDataset
from stable_nerf_tpu_torch.models.diffusion import unet as tunet
from stable_nerf_tpu_torch.models.diffusion.sd_network import (init_ip_from_unet,
                                                               sd_network_init)
from stable_nerf_tpu_torch.models.nerf.grid import OccupancyGridState
from stable_nerf_tpu_torch.models.nerf.network import nerf_init
from stable_nerf_tpu_torch.parallel import joint_fsdp_specs
from stable_nerf_tpu_torch.training import loop as tloop
from stable_nerf_tpu_torch.training.checkpoints import CheckpointManager
from stable_nerf_tpu_torch.utils.tree import combine, tree_leaves, tree_leaves_with_path
from test_torch_joint import _tiny_joint_config
from test_torch_loop import _jax_cli_config

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "mp_torch_worker.py")
WORLD = 2
B = 2                    # the global batch: one row a rank
TIMEOUT_S = 120          # each multi-process launch
KEY = 3


def _launch(mode, *args, flags=()):
    rc = tcli.launch_local(list(flags), WORLD,
                           command=[sys.executable, WORKER, mode, *map(str, args)],
                           timeout=TIMEOUT_S)
    assert rc == 0, f"a {mode} worker exited {rc}"


def _draws(key, b, enc):
    """The draws JAX's forward_iteration makes from ``key`` at batch ``b``
    (joint.py:221-284)."""
    k_vae, k_noise, k_t, k_perturb = jax.random.split(key, 4)
    return {"vae_eps": np.asarray(jax.random.normal(k_vae, (2 * b, 4, enc, enc))),
            "noise": np.asarray(jax.random.normal(k_noise, (b, 4, enc, enc))),
            "timesteps": np.asarray(jax.random.randint(k_t, (b,), 0, 1000)),
            "perturb": np.asarray(jax.random.uniform(k_perturb, (2 * b * enc * enc,)))}


def _rank_rows(draws, rank, world):
    """Rank ``rank``'s rows of global draws: target and reference rows of
    its samples (the step concatenates targets, then references)."""
    b = draws["noise"].shape[0]
    per = b // world
    rows = np.r_[rank * per:(rank + 1) * per, b + rank * per:b + (rank + 1) * per]
    two_b = lambda x: x.reshape(2 * b, -1)[rows].reshape(-1, *x.shape[1:])  # noqa: E731
    return {"vae_eps": two_b(draws["vae_eps"]),
            "noise": draws["noise"][rank * per:(rank + 1) * per],
            "timesteps": draws["timesteps"][rank * per:(rank + 1) * per],
            "perturb": draws["perturb"].reshape(2 * b, -1)[rows].reshape(-1)}


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """One launch of two worker ranks (started first, so they run while
    JAX compiles its two steps here) and JAX's data-parallel and
    single-device updates from the same weights, batch and key."""
    out = tmp_path_factory.mktemp("steps")
    jcfg = _tiny_joint_config()
    tcfg = convert.config_from_jax(jcfg)
    seed_tree = {"sd": init_ip_from_unet(sd_network_init(0, tcfg.sd, device="cpu")),
                 "nerf": nerf_init(1, tcfg.nerf, device="cpu")}
    like = jax.eval_shape(lambda: {
        "sd": jsd.sd_network_init(jax.random.PRNGKey(0), jcfg.sd),
        "nerf": jnerf_init(jax.random.PRNGKey(1), jcfg.nerf)})
    jparams = jax.tree.map(jnp.asarray, convert.params_to_jax(seed_tree, like=like))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), like=seed_tree)
    grid = jgrid_init(jcfg.nerf)
    grid = grid._replace(occ=jnp.ones_like(grid.occ))
    batch = ge._make_batch(jcfg, B, jax.random.PRNGKey(1))
    key = jax.random.PRNGKey(KEY)
    enc = jcfg.latent_hw
    glob = _draws(key, B, enc)
    inputs = {
        "cfg": tcfg, "params": params, "min_size": 1 << 8,
        "grid": OccupancyGridState(*(torch.from_numpy(np.array(a)) for a in grid)),
        "batch": _torch(batch),
        "draws_dp": [_torch(_draws(jax.random.fold_in(key, r), B // WORLD, enc))
                     for r in range(WORLD)],
        "draws_fsdp": [_torch(_rank_rows(glob, r, WORLD)) for r in range(WORLD)],
    }
    torch.save(inputs, out / "inputs.pt")
    with concurrent.futures.ThreadPoolExecutor(1) as pool, pytest.MonkeyPatch.context() as mp:
        launched = pool.submit(_launch, "steps", out / "inputs.pt", out)
        # JAX's make_train_step computes in its default bf16: hold both
        # packages' steps in float32, as tests/test_torch_joint.py does
        mp.setattr(jj, "forward_iteration",
                   functools.partial(jj.forward_iteration, compute_dtype=jnp.float32))

        sched = JDDIMScheduler.create(jcfg.sd.scheduler)
        mask = jj.joint_trainable_mask(jparams)
        opt = jj.make_optimizer(jcfg.train)
        trainable, _ = jpartition(jparams, mask)
        state = opt.init(trainable)
        mesh = jmake_mesh(WORLD)
        dp = jparallel_step(jj.make_train_step(jcfg, sched, opt, mask, pmean_axis="data"),
                            mesh)
        single = jax.jit(jj.make_train_step(jcfg, sched, opt, mask))
        dp_args = (jreplicate(jparams, mesh), jreplicate(state, mesh),
                   jreplicate(grid, mesh), jshard_batch(batch, mesh), key)
        one_args = (jparams, state, grid, batch, key)
        # XLA compiles the two steps in threads of its own at once
        with concurrent.futures.ThreadPoolExecutor(2) as compiling:
            dp_c, single_c = compiling.map(lambda f_a: f_a[0].lower(*f_a[1]).compile(),
                                           [(dp, dp_args), (single, one_args)])
        p_dp, _, m_dp = dp_c(*dp_args)
        p_one, _, m_one = single_c(*one_args)
        launched.result()
    ranks = [torch.load(out / f"steps_{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"ranks": ranks, "jparams": jparams, "mask": mask, "before": params,
            "jax": {"dp": (jax.tree.map(np.asarray, p_dp), m_dp),
                    "fsdp": (jax.tree.map(np.asarray, p_one), m_one)}}


def test_least_squares_grads_are_averaged_not_summed(world2):
    """tests/test_joint_training.py:216 at world 2: each rank's gradient,
    update and loss are the global batch's, and JAX's shard_map step on a
    2-device mesh agrees."""
    x = np.arange(32, dtype=np.float32).reshape(8, 4) / 10.0
    y = np.ones(8, np.float32)
    grad = np.mean(2 * (x @ np.zeros(4, np.float32) - y)[:, None] * x, axis=0)
    mesh = jmake_mesh(WORLD)

    def step_fn(params, opt_state, grid_state, batch, k):
        loss, g = jax.value_and_grad(
            lambda p: jnp.mean((batch["x"] @ p["w"] - batch["y"]) ** 2))(params)
        g = jax.lax.pmean(g, "data")
        return ({"w": params["w"] - 0.1 * g["w"]}, opt_state,
                {"loss": jax.lax.pmean(loss, "data"), "grad": g["w"]})

    jw, _, jm = jparallel_step(step_fn, mesh)({"w": jnp.zeros(4)}, None, None,
                                              jshard_batch({"x": x, "y": y}, mesh),
                                              jax.random.PRNGKey(0))
    for r in world2["ranks"]:
        ls = r["least_squares"]
        np.testing.assert_allclose(ls["grad"].numpy(), grad, rtol=1e-5)
        np.testing.assert_allclose(ls["w"].numpy(), -0.1 * grad, rtol=1e-5)
        np.testing.assert_allclose(float(ls["loss"]), 1.0, rtol=1e-6)
        np.testing.assert_allclose(ls["grad"].numpy(), np.asarray(jm["grad"]), rtol=1e-5)
        np.testing.assert_allclose(ls["w"].numpy(), np.asarray(jw["w"]), rtol=1e-5)


def test_process_shard_indices_replicate_barrier_and_fold(world2):
    ranks = [r["collectives"] for r in world2["ranks"]]
    assert [r["world"] for r in world2["ranks"]] == [WORLD] * WORLD
    assert {r["backend"] for r in world2["ranks"]} == {"gloo"}
    # disjoint contiguous slices; the remainder of an uneven count dropped
    assert ranks[0]["shard"] + ranks[1]["shard"] == list(range(10))
    assert ranks[0]["shard_uneven"] == [0, 1, 2, 3, 4]
    assert ranks[1]["shard_uneven"] == [5, 6, 7, 8, 9]
    # every leaf (bool, int, a transposed view) equals rank 0's bit for bit
    want = {"a": torch.full((3,), 1.0), "b": [torch.tensor(0, dtype=torch.int32),
                                              torch.tensor([True, True])],
            "c": torch.arange(6.0).reshape(2, 3).t()}
    for r in ranks:
        for got, w in zip(tree_leaves(r["replicated"]), tree_leaves(want)):
            assert torch.equal(got, w) and got.dtype == w.dtype
    assert ranks[0]["mark_seen"]
    # each rank's folded stream is its own
    assert not torch.equal(ranks[0]["folded"], ranks[1]["folded"])


@pytest.mark.parametrize("mode", ["dp", "fsdp"])
def test_joint_step_at_world_2_matches_jax(world2, mode):
    """dp: JAX's shard_map step at world 2; fsdp: JAX's single-device step
    on the global batch.  Both ranks report the same averaged losses and
    hold the same updated trainables."""
    want_params, want_m = world2["jax"][mode]
    before = convert.params_to_jax(world2["before"], like=world2["jparams"])
    r0, r1 = (r[mode] for r in world2["ranks"])
    assert r0["metrics"] == r1["metrics"]
    for k in ("loss", "sd_loss", "nerf_loss"):
        np.testing.assert_allclose(r0["metrics"][k], float(want_m[k]), rtol=1e-5,
                                   err_msg=k)
    for a, b in zip(tree_leaves(r0["trainable"]), tree_leaves(r1["trainable"])):
        assert a is None and b is None or torch.equal(a, b)
    # the updated trainables over the frozen leaves as they were
    got = convert.params_to_jax(combine(r0["trainable"], world2["before"]),
                                like=world2["jparams"])
    n = 0
    for (path, g), w, b, m in zip(
            jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(want_params),
            jax.tree.leaves(before), jax.tree.leaves(world2["mask"])):
        name = jax.tree_util.keystr(path)
        if not m:
            np.testing.assert_array_equal(w, b, err_msg=name)    # frozen in JAX too
            continue
        if "color_mlp" in name:
            continue
        upd = np.asarray(w) - np.asarray(b)
        err = np.linalg.norm((np.asarray(g) - np.asarray(b)) - upd) / np.linalg.norm(upd)
        assert err <= 1e-3, (name, err)
        n += 1
    assert n > 10


def test_fsdp_shards_jax_leaves_and_rests_on_half_the_bytes(world2):
    """The sharded leaves of the worker's fully-sharded step (min_size 2^8)
    are the non-P() leaves of JAX's joint_fsdp_specs at a 2-device mesh;
    each rank rests on half of their bytes, and its AdamW moments are
    slices."""
    from jax.sharding import PartitionSpec as P

    r0, r1 = (r["fsdp"] for r in world2["ranks"])
    specs = jfsdp_specs(world2["jparams"], jmake_mesh(WORLD), min_size=1 << 8)
    want = {jax.tree_util.keystr(path) for path, s in
            jax.tree_util.tree_leaves_with_path(specs, is_leaf=lambda x: isinstance(x, P))
            if s != P()}
    assert set(r0["specs"]) == set(r1["specs"]) == want and want
    sizes = dict((jax.tree_util.keystr(p), x.size) for p, x in
                 jax.tree_util.tree_leaves_with_path(world2["jparams"]))
    shardable = sum(sizes[k] for k in want) * 4          # float32 leaves
    kept = r0["sd_bytes_whole"] - shardable
    assert r0["sd_bytes_resting"] == r1["sd_bytes_resting"] == kept + shardable // WORLD
    trainable = sum(x.numel() for x in tree_leaves(r0["trainable"]) if x is not None)
    assert r0["moment_elems"] < trainable


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("min_size", [1 << 8, 1 << 15])
def test_fsdp_specs_equal_jax(world, min_size):
    """The port's sharded-leaf set equals the JAX package's at every mesh
    size and threshold, at the tiny SD (the flagship's rule is the same
    code); the NeRF stays replicated."""
    from jax.sharding import PartitionSpec as P

    jcfg = _tiny_joint_config()
    tcfg = convert.config_from_jax(jcfg)
    params = {"sd": init_ip_from_unet(sd_network_init(0, tcfg.sd, device="cpu")),
              "nerf": nerf_init(1, tcfg.nerf, device="cpu")}
    like = jax.eval_shape(lambda: {
        "sd": jsd.sd_network_init(jax.random.PRNGKey(0), jcfg.sd),
        "nerf": jnerf_init(jax.random.PRNGKey(1), jcfg.nerf)})
    specs = jfsdp_specs(like, jmake_mesh(world), min_size=min_size)
    want = {jax.tree_util.keystr(path) for path, s in
            jax.tree_util.tree_leaves_with_path(specs, is_leaf=lambda x: isinstance(x, P))
            if s != P()}
    got = {path for path, d in tree_leaves_with_path(
        joint_fsdp_specs(params, world, min_size=min_size)) if d is not None}
    assert got == want
    assert not any(p.startswith("['nerf']") for p in got)
    for path, d in tree_leaves_with_path(joint_fsdp_specs(params, world,
                                                          min_size=min_size)):
        if d is not None:
            x = dict(tree_leaves_with_path(params))[path]
            assert x.shape[d] % world == 0 and x.numel() >= min_size


@pytest.fixture(scope="module")
def unet_grads():
    """The tiny U-Net's input and weight gradients: the port plain, the
    port with remat, JAX with remat; same weights and inputs."""
    jcfg = _tiny_joint_config().sd.unet
    jcfg_remat = dataclasses.replace(jcfg, remat=True)
    tcfg = convert.config_from_jax(jcfg)
    tcfg_remat = convert.config_from_jax(jcfg_remat)
    assert tcfg_remat.remat and not tcfg.remat
    params = init_ip_from_unet({"unet": tunet.unet_init(
        torch.Generator().manual_seed(4), tcfg)})["unet"]
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((2, 4, 16, 16)).astype(np.float32)
    ctx = rng.standard_normal((2, 4, 48)).astype(np.float32)
    kw = dict(added_text_embeds=rng.standard_normal((2, 32)).astype(np.float32),
              added_time_ids=np.full((2, 6), 32.0, np.float32))
    t = np.asarray([10, 700])
    target = rng.standard_normal((2, 4, 16, 16)).astype(np.float32)

    def port(cfg):
        leaves = [x.detach().clone().requires_grad_(True) for x in tree_leaves(params)]
        p = _with_leaves(params, leaves)
        x = torch.from_numpy(lat).requires_grad_(True)
        eps = tunet.unet_apply(p, x, torch.from_numpy(t), torch.from_numpy(ctx), cfg=cfg,
                               **{k: torch.from_numpy(v) for k, v in kw.items()})
        ((eps - torch.from_numpy(target)) ** 2).mean().backward()
        return x.grad, [leaf.grad for leaf in leaves]

    jp = jax.tree.map(jnp.asarray, convert.params_to_jax(params))

    def jloss(p, x):
        eps = junet.unet_apply(p, x, jnp.asarray(t), jnp.asarray(ctx), cfg=jcfg_remat,
                               **{k: jnp.asarray(v) for k, v in kw.items()})
        return jnp.mean((eps - jnp.asarray(target)) ** 2)

    jg, jx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(lat))
    return {"plain": port(tcfg), "remat": port(tcfg_remat), "params": params,
            "jax": (np.asarray(jx), convert.params_from_jax(
                jax.tree.map(np.asarray, jg), like=params))}


def _with_leaves(tree, leaves):
    """``tree`` with its leaves (in tree_leaves order) replaced."""
    it = iter(leaves)
    paths = [p for p, _ in tree_leaves_with_path(tree)]
    flat = dict(zip(paths, it))

    def build(t, prefix=""):
        if isinstance(t, dict):
            return {k: build(v, f"{prefix}[{k!r}]") for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [build(v, f"{prefix}[{i}]") for i, v in enumerate(t)]
        return flat[prefix]

    return build(tree)


def test_remat_gradients_equal_the_plain_unet_and_jax(unet_grads):
    (px, pg), (rx, rg) = unet_grads["plain"], unet_grads["remat"]
    # remat recomputes the same float32 ops: bit for bit on the CPU
    assert torch.equal(px, rx)
    assert len(pg) == len(rg) and all(torch.equal(a, b) for a, b in zip(pg, rg))
    jx, jg = unet_grads["jax"]
    for got, want in [(rx, jx)] + list(zip(rg, tree_leaves(jg))):
        want = np.asarray(want, np.float32)
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * scale)


def test_remat_is_off_while_attention_maps_are_captured(unet_grads):
    """Capturing the ip maps appends as the forward runs: under remat it
    still captures each layer's map once."""
    tcfg = convert.config_from_jax(dataclasses.replace(_tiny_joint_config().sd.unet,
                                                       remat=True))
    x = torch.zeros((1, 4, 16, 16), requires_grad=True)
    args = (torch.tensor([5]), torch.zeros((1, 4, 48)))
    kw = dict(added_text_embeds=torch.zeros((1, 32)), added_time_ids=torch.zeros((1, 6)))
    eps, aux = tunet.unet_apply(unet_grads["params"], x, *args, cfg=tcfg,
                                capture_ip_attn_maps=True, **kw)
    eps.sum().backward()
    plain = tunet.unet_apply(unet_grads["params"], x, *args,
                             cfg=dataclasses.replace(tcfg, remat=False),
                             capture_ip_attn_maps=True, **kw)[1]
    assert len(aux["ip_attn_maps"]) == len(plain["ip_attn_maps"]) > 0


def test_cli_parallel_flags_build_the_configuration_train_py_builds():
    argv = ["--tiny", "--remat", "--fsdp", "--data-parallel"]
    want = _jax_cli_config(argv)
    got = tcli.build_config(tcli.build_parser().parse_args(argv))
    assert got.sd.unet.remat and convert.config_from_jax(want.sd.unet) == got.sd.unet


@pytest.mark.parametrize("argv,message", [
    (["--coordinator", "localhost:1"], "--num-processes and --process-id"),
    (["--coordinator", "localhost:1", "--num-processes", "2"],
     "--num-processes and --process-id"),
    (["--distributed"], "need --workdir"),
    (["--distributed", "--workdir", "unused"], "start the processes with torchrun")])
def test_cli_refuses_an_incomplete_process_group(argv, message, monkeypatch):
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(SystemExit) as e:
        tcli.main(["--tiny", "--device", "cpu"] + argv)
    assert message in str(e.value.code)


# -- the CLI across two processes --------------------------------------------

CLI = ["--tiny", "--dataset", "nerf", "--image-size", "32", "--latent-size", "16",
       "--max-steps", "16", "--max-steps-eval", "16", "--num-inference-steps", "2",
       "--inference-every", "1", "--checkpoint-every", "1", "--device", "cpu"]
VIEWS = 12               # a 9 / 1 / 2 split: 4 train steps a rank


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """The committed synthetic scene's first views as a tiny-NeRF file."""
    root = tmp_path_factory.mktemp("data")
    scene = np.load(os.path.join(REPO, "datasets", "nerf", "synthetic_spheres.npz"))
    os.makedirs(root / "nerf")
    np.savez(root / "nerf" / "tiny_nerf_data.npz", images=scene["images"][:VIEWS],
             poses=scene["poses"][:VIEWS], focal=scene["focal"])
    return str(root)


def _cli_cfg(extra=()):
    return tcli.build_config(tcli.build_parser().parse_args(CLI + list(extra)))


def _records(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _dataset(root):
    return TDataset("nerf", shape=32, encoded_shape=16, root=root)


def _equal_trees(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) and x.dtype == y.dtype
                                      for x, y in zip(la, lb))


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory, data_root):
    """Two-process CLI runs: one data-parallel epoch; one fully-sharded
    epoch with trainable-only checkpoints and bf16 frozen weights."""
    runs = {}
    for name, extra in (("dp", ["--data-parallel"]),
                        ("fsdp", ["--fsdp", "--frozen-bf16",
                                  "--checkpoint-trainable-only"])):
        out = tmp_path_factory.mktemp(name)
        workdir = str(out / "work")
        extra = extra + ["--data-root", data_root]
        _launch("cli", out, flags=CLI + extra + ["--epochs", "1", "--workdir", workdir])
        runs[name] = {"extra": extra, "workdir": workdir, "out": out, "root": data_root,
                      "ranks": [torch.load(out / f"cli_{r}.pt", weights_only=False)
                                for r in range(WORLD)]}
    return runs


def test_cli_data_parallel_rank0_writes_and_grid_equal(cli_runs):
    run = cli_runs["dp"]
    r0, r1 = run["ranks"]
    # rank 0 alone writes: one epoch record and one inference record
    assert [(r["epoch"], r.get("kind")) for r in _records(run["workdir"])] == \
        [(0, None), (0, "inference")]
    assert sorted(os.listdir(os.path.join(run["workdir"], "checkpoints"))) == ["1.pt"]
    assert all(torch.equal(a, b) for a, b in zip(r0["grid"], r1["grid"]))
    assert int(r0["grid"][3]) == 1
    assert _equal_trees(r0["params"], r1["params"])
    assert r0["history"][0]["train_loss"] == r1["history"][0]["train_loss"]
    assert np.isfinite(r0["history"][0]["val_loss"])


@pytest.mark.parametrize("name", ["dp", "fsdp"])
def test_cli_checkpoint_restores_single_process_bit_for_bit(cli_runs, name, tmp_path):
    """A nothing-to-do resume returns the restored state: the run's own."""
    run = cli_runs[name]
    workdir = str(tmp_path / "w")
    shutil.copytree(run["workdir"], workdir)
    params, grid, history = tloop.train(_cli_cfg(run["extra"]), _dataset(run["root"]),
                                        workdir=workdir, epochs=1, resume=True,
                                        log_fn=lambda m: None, device="cpu")
    assert history == []
    assert _equal_trees(params, run["ranks"][0]["params"])
    assert all(torch.equal(a, b) for a, b in zip(grid, run["ranks"][0]["grid"]))


def test_cli_fsdp_checkpoint_resumes_single_process_and_back(cli_runs, tmp_path):
    """The fully-sharded epoch's checkpoint continues single-process for a
    second epoch; that single-process checkpoint restores into a
    fully-sharded two-process run bit for bit."""
    run = cli_runs["fsdp"]
    workdir = str(tmp_path / "w")
    shutil.copytree(run["workdir"], workdir)
    logs = []
    params, grid, history = tloop.train(_cli_cfg(run["extra"]), _dataset(run["root"]),
                                        workdir=workdir, epochs=2, resume=True,
                                        log_fn=logs.append, device="cpu")
    assert [r["epoch"] for r in history] == [1]
    assert any("resumed from checkpoint step 1 (epoch 1, trainable-only" in m for m in logs)
    raw = CheckpointManager(os.path.join(workdir, "checkpoints")).restore()
    assert "trainable" in raw and "params" not in raw
    # the reverse: resume the single-process checkpoint fully sharded
    _launch("cli", tmp_path, flags=CLI + run["extra"] + ["--epochs", "2", "--resume",
                                                         "--workdir", workdir])
    for r in range(WORLD):
        back = torch.load(tmp_path / f"cli_{r}.pt", weights_only=False)
        assert back["history"] == []
        assert _equal_trees(back["params"], params)
        assert all(torch.equal(a, b) for a, b in zip(back["grid"], grid))
