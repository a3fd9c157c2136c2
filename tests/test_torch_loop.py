"""The port's training loop (training/loop.py), its lr schedules and its
CLI (stable_nerf_tpu_torch/train.py) against the JAX package's on the
CPU, on the tiny configuration (``--tiny``) at image 32 / latent 16 over
the first 10 scenes of the committed synthetic scene (an 8 / 1 / 1 split).

The two loops draw their training numbers from different generators, so
they are compared on what does not depend on them: the split, the order
in which every sample is read (train shuffles, validation, inference),
the checkpoint steps on disk, the visualization dumps and the keys of
every ``metrics.jsonl`` record — all exactly equal.  The lr factors
against optax's schedules within 1e-6 relative (optax evaluates them in
float32, the port in float64); a 5-update AdamW run with a schedule
within 1e-6 relative or 5e-5·lr absolute (optax's float32 bias
correction, see the test).
"""

import dataclasses
import json
import os
import shutil
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import train as jcli
from stable_nerf_tpu.data.dataset import StableNeRFDataset as JDataset
from stable_nerf_tpu.training import joint as jj
from stable_nerf_tpu.training.loop import train as jtrain
from stable_nerf_tpu_torch import convert
from stable_nerf_tpu_torch import train as tcli
from stable_nerf_tpu_torch.data.dataset import StableNeRFDataset as TDataset
from stable_nerf_tpu_torch.training import joint as tj
from stable_nerf_tpu_torch.training import loop as tloop
from stable_nerf_tpu_torch.training.checkpoints import CheckpointManager
from stable_nerf_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.join(REPO, "datasets")
N_SCENES = 10
LOOP = dict(batch_size=2, max_steps_train=16, max_steps_eval=16, inference_every=2,
            num_inference_steps=2, checkpoint_every=1, vis_sample_prob=0.3)
ARGS = ["--tiny", "--image-size", "32", "--latent-size", "16"]


class _View:
    """The first ``n`` scenes of a dataset; logs every index read."""

    def __init__(self, ds, n=N_SCENES):
        self.ds, self.n, self.intrinsic, self.seen = ds, n, ds.intrinsic, []

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if not 0 <= i < self.n:
            raise IndexError(i)
        self.seen.append(int(i))
        return self.ds[i]

    def all_poses(self):
        return np.concatenate([self.ds.reference_poses[:self.n],
                               self.ds.target_poses[:self.n]])


def _cfgs(**train):
    """The same configuration for both packages, as each CLI builds it."""
    t = tcli.build_config(tcli.build_parser().parse_args(ARGS))
    t = dataclasses.replace(t, train=dataclasses.replace(t.train, **{**LOOP, **train}))
    j = _jax_cli_config(ARGS)
    j = dataclasses.replace(j, train=dataclasses.replace(j.train, **{**LOOP, **train}))
    return j, t


def _jax_cli_config(argv):
    """train.py's JointConfig for ``argv``, built by its own main() up to
    the point where it loads data."""
    from unittest import mock

    class Loaded(Exception):
        pass

    seen, joint_config_cls = {}, jj.JointConfig

    def joint_config(**kw):
        seen["cfg"] = joint_config_cls(**kw)
        return seen["cfg"]

    with mock.patch("stable_nerf_tpu.training.joint.JointConfig", joint_config), \
            mock.patch("stable_nerf_tpu.data.dataset.StableNeRFDataset",
                       mock.Mock(side_effect=Loaded)):
        with pytest.raises(Loaded):
            jcli.main(argv + ["--workdir", "unused", "--compile-cache", "none"])
    return seen["cfg"]


def _steps_on_disk(ckpt_dir):
    return sorted(int(f.split(".")[0]) for f in os.listdir(ckpt_dir)
                  if f.split(".")[0].isdigit() and not f.endswith(".tmp"))


def _records(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _vis(workdir):
    d = os.path.join(workdir, "visualizations")
    if not os.path.isdir(d):
        return []
    return sorted((f, np.load(os.path.join(d, f)).shape) for f in os.listdir(d))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two epochs of each loop, with the same settings, split and data."""
    jcfg, tcfg = _cfgs()
    out = {"tcfg": tcfg}
    for name, ds_cls, fn, kw in (
            ("jax", JDataset, jtrain, {}),
            ("port", TDataset, tloop.train,
             {"device": "cpu", "profile_dir": str(tmp_path_factory.mktemp("prof"))})):
        view = _View(ds_cls("synthetic", shape=32, encoded_shape=16, root=ROOT))
        workdir = str(tmp_path_factory.mktemp(name))
        logs = []
        params, grid, history = fn(jcfg if name == "jax" else tcfg, view,
                                   workdir=workdir, epochs=2, log_fn=logs.append, **kw)
        out[name] = dict(view=view, workdir=workdir, params=params, grid=grid,
                         history=history, logs=logs, **kw)
    return out


def test_loop_reads_saves_and_records_as_jax(runs):
    j, t = runs["jax"], runs["port"]
    assert len(t["view"].seen) == 22       # 2 × (4 steps of 2 + 1 padded val batch) + 2
    assert t["view"].seen == j["view"].seen
    assert _steps_on_disk(os.path.join(t["workdir"], "checkpoints")) == \
        _steps_on_disk(os.path.join(j["workdir"], "checkpoints")) == [1, 2]
    jrec, trec = _records(j["workdir"]), _records(t["workdir"])
    assert [sorted(r) for r in trec] == [sorted(r) for r in jrec]
    assert [(r["epoch"], r.get("kind")) for r in trec] == [(0, None), (1, None),
                                                          (1, "inference")]
    assert [r["epoch"] for r in t["history"]] == [r["epoch"] for r in j["history"]]
    for r in trec:
        assert all(np.isfinite(v) for k, v in r.items() if k != "kind"), r
    assert _vis(t["workdir"]) == _vis(j["workdir"]) != []
    assert int(t["grid"].iter_density) == int(j["grid"].iter_density) == 2
    assert os.path.exists(os.path.join(t["profile_dir"], "trace.json"))
    assert any("grid refresh" in m for m in t["logs"])


def test_resume_restores_the_saved_state_and_continues(runs, tmp_path):
    t = runs["port"]
    workdir = str(tmp_path / "w")
    shutil.copytree(t["workdir"], workdir)
    view = _View(t["view"].ds)
    logs = []
    # nothing left to do: the restored state comes back as it was saved
    params, grid, history = tloop.train(runs["tcfg"], view, workdir=workdir, epochs=2,
                                        resume=True, log_fn=logs.append, device="cpu")
    assert history == [] and view.seen == []
    assert any("resumed from checkpoint step 2 (epoch 2)" in m for m in logs)
    for a, b in zip(tree_leaves(params), tree_leaves(t["params"])):
        assert torch.equal(a, b) and a.dtype == b.dtype
    for a, b in zip(grid, t["grid"]):
        assert torch.equal(a, b)
    assert _steps_on_disk(os.path.join(workdir, "checkpoints")) == [1, 2]
    # one more epoch, numbered on from the checkpoint
    params, grid, history = tloop.train(runs["tcfg"], view, workdir=workdir, epochs=3,
                                        resume=True, log_fn=logs.append, device="cpu")
    assert [r["epoch"] for r in history] == [2]
    assert int(grid.iter_density) == 3
    assert [r["epoch"] for r in _records(workdir)] == [0, 1, 1, 2]
    assert _steps_on_disk(os.path.join(workdir, "checkpoints")) == [1, 2, 3]


def test_trainable_only_resume_verifies_and_refuses_another_seed(tmp_path):
    _, tcfg = _cfgs(frozen_dtype="bfloat16", checkpoint_trainable_only=True,
                    inference_every=0, vis_sample_prob=0.0, val_every=0)
    view = _View(TDataset("synthetic", shape=32, encoded_shape=16, root=ROOT))
    workdir = str(tmp_path / "w")
    tloop.train(tcfg, view, workdir=workdir, epochs=1, log_fn=lambda m: None,
                device="cpu")
    fmt = json.load(open(os.path.join(workdir, "checkpoints", "FORMAT.json")))
    assert {k: fmt[k] for k in ("version", "trainable_only", "seed", "frozen_dtype")} == \
        {"version": 2, "trainable_only": True, "seed": 0, "frozen_dtype": "bfloat16"}
    assert sum(fmt["frozen_checksum"].values()) > 0
    raw = CheckpointManager(os.path.join(workdir, "checkpoints")).restore()
    assert "trainable" in raw and "params" not in raw
    logs = []
    _, _, hist = tloop.train(tcfg, view, workdir=workdir, epochs=2, resume=True,
                             log_fn=logs.append, device="cpu")
    assert [r["epoch"] for r in hist] == [1]
    assert "checkpoints: frozen checksum verified" in logs
    for resume in (True, False):
        with pytest.raises(ValueError, match="trainable-only checkpoint"):
            tloop.train(tcfg, view, workdir=workdir, epochs=3, resume=resume, seed=1,
                        log_fn=lambda m: None, device="cpu")


def test_sigterm_mid_epoch_saves_and_exits(tmp_path):
    _, tcfg = _cfgs(inference_every=0, vis_sample_prob=0.0, checkpoint_every=0)

    class Signalling(_View):
        """Sends this process SIGTERM when the third train sample is read."""

        def __getitem__(self, i):
            if len(self.seen) == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return super().__getitem__(i)

    view = Signalling(TDataset("synthetic", shape=32, encoded_shape=16, root=ROOT))
    workdir = str(tmp_path / "w")
    prev = signal.getsignal(signal.SIGTERM)
    logs = []
    _, _, history = tloop.train(tcfg, view, workdir=workdir, epochs=5, log_fn=logs.append,
                                device="cpu")
    assert history == []
    assert any("preempted (SIGTERM): resumable checkpoint saved; epoch 0 re-runs" in m
               for m in logs)
    assert signal.getsignal(signal.SIGTERM) is prev
    ckpt_dir = os.path.join(workdir, "checkpoints")
    assert _steps_on_disk(ckpt_dir) == [0]
    assert not [f for f in os.listdir(ckpt_dir) if f.endswith(".tmp")]
    _, _, history = tloop.train(tcfg, _View(view.ds), workdir=workdir, epochs=1,
                                resume=True, log_fn=logs.append, device="cpu")
    assert [r["epoch"] for r in history] == [0]


@pytest.mark.parametrize("schedule,steps,factor", [
    ("constant", 100, 0.1), ("exponential", 7, 0.1), ("exponential", 0, 0.1),
    ("exponential", 7, 0.0), ("cosine", 7, 0.1), ("cosine", 3, 0.0)])
def test_lr_factors_equal_optax(schedule, steps, factor):
    cfg = tj.TrainConfig(lr=3e-3, lr_schedule=schedule, lr_decay_steps=steps,
                         lr_decay_factor=factor)
    want = {"constant": lambda: optax.constant_schedule(cfg.lr),
            "exponential": lambda: optax.exponential_decay(cfg.lr, steps, factor),
            "cosine": lambda: optax.cosine_decay_schedule(cfg.lr, steps, alpha=factor)}[
                schedule]()
    f = tj.lr_factor(cfg)
    for n in range(12):
        np.testing.assert_allclose(cfg.lr * f(n), float(want(n)), rtol=1e-6, atol=1e-12)


def test_unknown_or_empty_schedules_raise_as_optax():
    with pytest.raises(ValueError, match="unknown lr_schedule"):
        tj.lr_factor(tj.TrainConfig(lr_schedule="linear"))
    with pytest.raises(ValueError):
        optax.cosine_decay_schedule(1.0, 0)
    with pytest.raises(ValueError, match="lr_decay_steps > 0"):
        tj.lr_factor(tj.TrainConfig(lr_schedule="cosine", lr_decay_steps=0))


@pytest.mark.parametrize("schedule,nerf_lr", [("exponential", None), ("cosine", 1e-2)])
def test_adamw_with_a_schedule_matches_optax(rng, schedule, nerf_lr):
    """Five updates on the same gradients: each parameter within 1e-6
    relative or 5e-5·lr absolute of optax's.  optax computes Adam's bias
    correction 1 − β₂ᵗ in float32, 1.3e-5 off at t = 1 (0.999 is no
    float32), torch in float64: an update differs by up to ~7e-6·lr, and
    five of them add up."""
    tcfg = tj.TrainConfig(lr=1e-2, lr_schedule=schedule, lr_decay_steps=3,
                          lr_decay_factor=0.1, nerf_lr=nerf_lr)
    jcfg = dataclasses.replace(jj.TrainConfig(), lr=1e-2, lr_schedule=schedule,
                               lr_decay_steps=3, lr_decay_factor=0.1, nerf_lr=nerf_lr)
    init = {"sd": {"a": rng.normal(size=(4, 3)).astype(np.float32)},
            "nerf": {"b": rng.normal(size=(5,)).astype(np.float32)}}
    grads = [jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32), init)
             for _ in range(5)]
    params = {k: {n: torch.tensor(v) for n, v in d.items()} for k, d in init.items()}
    mask = {"sd": {"a": True}, "nerf": {"b": True}}
    opt = tj.make_optimizer(tcfg, params, mask)
    sched = tj.make_lr_scheduler(tcfg, opt)
    jopt = jj.make_optimizer(jcfg)
    jp = jax.tree.map(jnp.asarray, init)
    state = jopt.init(jp)
    for g in grads:
        for part in params:
            for n, p in params[part].items():
                p.grad = torch.tensor(g[part][n])
        opt.step()
        opt.zero_grad()
        sched.step()
        updates, state = jopt.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        for part in params:
            for n, p in params[part].items():
                np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[part][n]),
                                           rtol=1e-6, atol=5e-5 * tcfg.lr)


def test_a_schedule_needs_its_scheduler_in_the_step():
    cfg = dataclasses.replace(_cfgs()[1], train=tj.TrainConfig(lr_schedule="cosine"))
    with pytest.raises(ValueError, match="make_lr_scheduler"):
        tj.make_train_step(cfg, None, None, device="cpu")


def test_cli_parser_has_every_flag_of_train_py():
    def flags(parser):
        return {a.option_strings[0]: a.default for a in parser._actions
                if a.option_strings and a.option_strings[0] != "-h"}

    port, ref = flags(tcli.build_parser()), flags(jcli.build_parser())
    assert set(port) - set(ref) == {"--device"}
    assert set(ref) <= set(port)
    assert {k: port[k] for k in ref} == ref
    assert port["--device"] == "cuda"


def test_cli_builds_the_configuration_train_py_builds():
    for argv in (ARGS, ARGS + ["--stochastic", "--stochastic-min-level", "2",
                               "--lr-schedule", "cosine", "--sample-budget", "auto",
                               "--frozen-bf16", "--checkpoint-trainable-only"],
                 ["--stochastic-until-epoch", "3", "--sample-budget", "4096",
                  "--trainable-scope", "sd", "--vae-encode", "mode", "--nerf-lr", "0.01"]):
        want = _jax_cli_config(argv)
        got = tcli.build_config(tcli.build_parser().parse_args(argv))
        assert convert.config_from_jax(want.nerf) == got.nerf
        assert convert.config_from_jax(want.train) == got.train
        assert got.sd.sd == convert.config_from_jax(want.sd.sd)


@pytest.mark.parametrize("flag", [["--data-parallel"], ["--tensor-parallel", "2"], ["--fsdp"],
                                  ["--sp", "2"], ["--distributed"],
                                  ["--coordinator", "h:1"], ["--remat"],
                                  ["--sdxl-checkpoint", "x"], ["--demo"],
                                  ["--vae-checkpoint", "x.npz"], ["--dataset", "objaverse"]])
def test_cli_refuses_unported_flags(flag):
    with pytest.raises(SystemExit) as e:
        tcli.main(ARGS + flag + ["--device", "cpu"])
    assert "not ported yet" in str(e.value.code) and "ROADMAP.md" in str(e.value.code)
    assert flag[0] in str(e.value.code)


def test_loop_refuses_parallel_and_pretrained_weights():
    _, tcfg = _cfgs()
    for kw in ({"data_parallel": True}, {"tensor_parallel": 2}, {"fsdp": True},
               {"mesh": object()}):
        with pytest.raises(NotImplementedError, match="parallel/"):
            tloop.train(tcfg, None, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="weights.py"):
        tloop.build_initial_params(tcfg, 0, 1, pretrained_sd={}, device="cpu")


def test_cli_inference_restores_and_writes_renders(runs, tmp_path, capsys):
    t = runs["port"]
    workdir = str(tmp_path / "w")
    shutil.copytree(t["workdir"], workdir)
    cfg = runs["tcfg"]
    tcli.run_inference(cfg, _View(t["view"].ds), workdir, save_attn_maps=True,
                       device="cpu")
    out = capsys.readouterr().out
    assert "Average L2 over test set" in out
    files = sorted(os.listdir(os.path.join(workdir, "renders")))
    assert any(f.startswith("denoised_0_0") for f in files)
    assert any(f.startswith("target_0_1") for f in files)
    assert "ip_attn_maps_0.npz" in files
