"""The port's checkpoints (training/checkpoints.py) on the CPU: an exact
round trip of params, AdamW state (its step counts included), lr schedule
and grid, ``max_to_keep``, the sweep of unfinished saves, and the
FORMAT.json rules, against the JAX package's manager where it decides the
same thing.

Tolerances: a round trip is bit for bit.  ``frozen_partition_checksum``
against JAX's within 1e-6 relative: both sum |x| per leaf in float32 and
add the leaves in one order, but XLA and PyTorch group a leaf's sum
differently.  ``verify_frozen_checksum`` must raise, warn or pass exactly
where JAX's does.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_nerf_tpu.config import HashGridConfig as JHashGridConfig
from stable_nerf_tpu.config import NeRFConfig as JNeRFConfig
from stable_nerf_tpu.config import SDConfig as JSDConfig
from stable_nerf_tpu.models.diffusion import sd_network as jsd
from stable_nerf_tpu.models.diffusion.unet import tiny_unet_config
from stable_nerf_tpu.models.diffusion.vae import VAEConfig as JVAEConfig
from stable_nerf_tpu.models.nerf import nerf_init as jnerf_init
from stable_nerf_tpu.training import checkpoints as jck
from stable_nerf_tpu.training import joint as jj
from stable_nerf_tpu_torch import convert
from stable_nerf_tpu_torch import train as tcli
from stable_nerf_tpu_torch.models.nerf.grid import OccupancyGridState, grid_init
from stable_nerf_tpu_torch.training import checkpoints as tck
from stable_nerf_tpu_torch.training import joint as tj
from stable_nerf_tpu_torch.training.loop import build_initial_params
from stable_nerf_tpu_torch.utils.tree import partition, tree_leaves

torch.set_num_threads(2)


def _tiny_cfg(**train):
    cfg = tcli.build_config(tcli.build_parser().parse_args(
        ["--tiny", "--image-size", "32", "--latent-size", "16"]))
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **train))


def _jax_like(tcfg):
    """The JAX package's tree structure for the tiny configuration."""
    jcfg = jj.JointConfig(
        nerf=JNeRFConfig(channel_dim=4, grid_size=32,
                         encoding_sigma=JHashGridConfig(n_levels=4, log2_hashmap_size=12,
                                                        base_resolution=4)),
        sd=jsd.SDNetworkConfig(
            sd=JSDConfig(latent_size=16, image_size=32, cross_attention_dim=48),
            unet=tiny_unet_config(),
            vae=JVAEConfig(block_out_channels=(16, 32), layers_per_block=1, norm_groups=8)))
    assert convert.config_from_jax(jcfg.nerf) == tcfg.nerf
    return jax.eval_shape(lambda: {
        "sd": jsd.sd_network_init(jax.random.PRNGKey(0), jcfg.sd),
        "nerf": jnerf_init(jax.random.PRNGKey(1), jcfg.nerf)})


def _trained_state(cfg, seed, steps=3):
    """Params, optimizer, lr schedule and grid after ``steps`` AdamW updates
    on random gradients."""
    params = build_initial_params(cfg, seed, seed + 1, device="cpu")
    mask = tj.joint_trainable_mask(params, cfg.train.trainable_scope)
    opt = tj.make_optimizer(cfg.train, params, mask)
    sched = tj.make_lr_scheduler(cfg.train, opt)
    g = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        for group in opt.param_groups:
            for p in group["params"]:
                p.grad = torch.randn(p.shape, generator=g)
        opt.step()
        opt.zero_grad()
        sched.step()
    grid = grid_init(cfg.nerf, device="cpu")
    grid = OccupancyGridState(torch.rand(grid.density_grid.shape, generator=g) - 0.2,
                              torch.rand(grid.occ.shape, generator=g) < 0.3,
                              torch.tensor(0.25), torch.tensor(7, dtype=torch.int32))
    return params, mask, opt, sched, grid


def _opt_state(opt, sched):
    return {"optimizer": opt.state_dict(), "lr_scheduler": sched.state_dict()}


def _same(a, b):
    return torch.equal(a, b) and a.dtype == b.dtype


@pytest.mark.parametrize("trainable_only", [False, True])
def test_round_trip_is_exact(tmp_path, trainable_only):
    cfg = _tiny_cfg(frozen_dtype="bfloat16", lr_schedule="cosine", lr_decay_steps=10,
                    nerf_lr=3e-3)
    params, mask, opt, sched, grid = _trained_state(cfg, seed=0)
    key = "trainable" if trainable_only else "params"
    saved = partition(params, mask)[0] if trainable_only else params
    mgr = tck.CheckpointManager(str(tmp_path / "ck"))
    assert mgr.save(3, saved, _opt_state(opt, sched), grid, extra={"epoch": 3},
                    params_key=key)
    assert mgr.latest_step() == 3

    # a fresh run of another seed, restored into its live tensors
    params2, mask2, opt2, sched2, grid2 = _trained_state(cfg, seed=5, steps=0)
    live = partition(params2, mask2)[0] if trainable_only else params2
    ids = [id(x) for x in tree_leaves(live) if x is not None]
    state = mgr.restore(template={key: live, "opt_state": None, "grid_state": grid2,
                                  "extra": None})
    assert [id(x) for x in tree_leaves(state[key]) if x is not None] == ids  # in place
    opt2.load_state_dict(state["opt_state"]["optimizer"])
    sched2.load_state_dict(state["opt_state"]["lr_scheduler"])
    assert state["extra"] == {"epoch": 3}

    for a, b, m in zip(tree_leaves(params), tree_leaves(params2), tree_leaves(mask)):
        if m or not trainable_only:
            assert _same(a, b)
    for a, b in zip(grid, state["grid_state"]):
        assert _same(a, b)
    assert isinstance(state["grid_state"], OccupancyGridState)
    assert [g["lr"] for g in opt2.param_groups] == [g["lr"] for g in opt.param_groups]
    assert sched2.last_epoch == sched.last_epoch == 3
    for p, p2 in zip([p for g in opt.param_groups for p in g["params"]],
                     [p for g in opt2.param_groups for p in g["params"]]):
        s, s2 = opt.state[p], opt2.state[p2]
        assert set(s) == set(s2) == {"step", "exp_avg", "exp_avg_sq"}
        for k in s:
            assert _same(s[k], s2[k]), k
        assert float(s2["step"]) == 3


def test_a_wrong_layout_or_shape_is_refused(tmp_path):
    cfg = _tiny_cfg()
    params, mask, opt, sched, grid = _trained_state(cfg, seed=0, steps=1)
    mgr = tck.CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, partition(params, mask)[0], _opt_state(opt, sched), grid,
             params_key="trainable")
    with pytest.raises(KeyError, match="checkpoint has"):       # v2 into a v1 template
        mgr.restore(template={"params": params, "opt_state": None, "grid_state": grid,
                              "extra": None})
    grid_big = grid_init(dataclasses.replace(cfg.nerf, grid_size=16), device="cpu")
    with pytest.raises(ValueError, match="expected"):
        mgr.restore(template={"trainable": partition(params, mask)[0], "opt_state": None,
                              "grid_state": grid_big, "extra": None})


def test_max_to_keep_and_duplicate_steps(tmp_path):
    grid = grid_init(_tiny_cfg().nerf, device="cpu")
    mgr = tck.CheckpointManager(str(tmp_path / "ck"), max_to_keep=3)
    for step in range(1, 6):
        assert mgr.save(step, {"w": torch.full((2,), float(step))}, {}, grid,
                        extra={"epoch": step})
    assert mgr.all_steps() == [3, 4, 5]
    # a step at or before the latest is skipped, as orbax skips it
    assert not mgr.save(5, {"w": torch.zeros(2)}, {}, grid)
    assert not mgr.save(4, {"w": torch.zeros(2)}, {}, grid)
    assert mgr.restore()["params"]["w"].tolist() == [5.0, 5.0]
    assert mgr.restore(4)["extra"] == {"epoch": 4}
    mgr.wait_until_finished()
    mgr.close()


def test_unfinished_saves_are_swept_and_never_reported(tmp_path):
    d = tmp_path / "ck"
    mgr = tck.CheckpointManager(str(d))
    mgr.save(2, {"w": torch.ones(3)}, {}, grid_init(_tiny_cfg().nerf, device="cpu"))
    (d / "9.pt.tmp").write_bytes(b"half a checkpoint")
    (d / "notes.txt").write_text("not a step")
    assert mgr.latest_step() == 2               # a temporary file is no step
    mgr2 = tck.CheckpointManager(str(d))
    assert sorted(os.listdir(d)) == ["2.pt", "notes.txt"]
    assert mgr2.latest_step() == 2
    assert tck.CheckpointManager(str(tmp_path / "empty")).restore() is None


def test_format_conflicts_refused_as_jax_refuses(tmp_path):
    base = {"version": 2, "trainable_only": True, "seed": 0, "pretrained_sd": False,
            "frozen_dtype": "bfloat16", "trainable_scope": "reference",
            "sdxl_fingerprint": None, "frozen_checksum": {"unet": 1.0}}
    calls = [base, dict(base, frozen_checksum={"unet": 2.0}),   # derived: no conflict
             dict(base, sdxl_checkpoint_path="/x"),             # not a reconstruction key
             dict(base, seed=1), dict(base, frozen_dtype=None),
             dict(base, trainable_scope="sd"), {"seed": 0}]
    outcomes = []
    for i, mgr in enumerate([tck.CheckpointManager(str(tmp_path / "t")),
                             jck.CheckpointManager(str(tmp_path / "j"))]):
        row = []
        for fmt in calls:
            try:
                mgr.write_format(fmt)
                row.append("ok")
            except ValueError as e:
                assert "refusing to write checkpoints" in str(e)
                row.append("refused")
        row.append(mgr.read_format())
        outcomes.append(row)
        mgr.close()
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][:-1] == ["ok", "ok", "ok", "refused", "refused", "refused", "ok"]
    assert outcomes[0][-1] == base


def test_frozen_partition_checksum_equals_jax():
    cfg = _tiny_cfg(frozen_dtype="bfloat16")
    params = build_initial_params(cfg, 0, 1, device="cpu")
    mask = tj.joint_trainable_mask(params)
    got = tck.frozen_partition_checksum(params, mask)
    jparams = jax.tree.map(jnp.asarray, convert.params_to_jax(params, like=_jax_like(cfg)))
    want = jck.frozen_partition_checksum(jparams, jj.joint_trainable_mask(jparams))
    assert set(got) == set(want) == {"add_text_embeds", "add_time_ids", "unet", "vae"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    assert sum(got.values()) > 0


@pytest.mark.parametrize("recorded,rebuilt", [
    (None, {"a": 1.0}), ({}, {"a": 1.0}), ({"a": 2.0}, {"a": 2.0}),
    ({"a": 2.0}, {"a": 2.0 * (1 + 1e-5)}), ({"a": 2.0}, {"a": 2.0 * (1 + 1e-2)}),
    ({"a": 2.0, "b": 1.0}, {"a": 2.0}), ({"a": 0.0}, {"a": 0.0})])
def test_verify_frozen_checksum_outcomes_equal_jax(recorded, rebuilt):
    outcomes = []
    for mod in (tck, jck):
        logs = []
        try:
            mod.verify_frozen_checksum(recorded, rebuilt, log_fn=logs.append)
            outcomes.append(("ok", len(logs)))
        except ValueError as e:
            assert "checksum mismatch" in str(e)
            outcomes.append(("raised", len(logs)))
    assert outcomes[0] == outcomes[1]
